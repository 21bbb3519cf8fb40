#!/usr/bin/env python3
"""Run one cell of the benchmark of bfqzip_tpu_torch on the card.

    python3 benchmark/run.py --workload hiseq101.batch --seed 7 --seconds 30 --trace 0

From the root of a checkout.  The cell's configuration, traffic and entry
are found by name under benchmark/ (see harness.py).  The last line of
standard output is one JSON object (correct, attempted, failed, metrics,
device, and with --trace 1 breakdown; the compared numbers with their limits
come last, under "checks", and again as the last lines of standard error).
Without a CUDA card, or with fewer cards than the cell needs, or where
`sys.modules` holds JAX or the JAX package once the run is done (searched
whole by top-level name, here and in a cell's other processes), it exits 2
and prints no result.  Caches of the program's builds stay inside the checkout.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import argparse  # noqa: E402
import json  # noqa: E402

import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    harness.use_checkout_caches()  # before torch is imported

    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    except harness.Refused as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    found = harness.forbidden_modules()  # once more, just before the result is printed
    if found:
        print(f"benchmark: modules of JAX or of the JAX package are loaded: {', '.join(found)}",
              file=sys.stderr)
        return 2
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

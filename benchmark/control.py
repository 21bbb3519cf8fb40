#!/usr/bin/env python3
"""Readings that set the limits of `correct`: sound runs and the control, per seed.

    python3 benchmark/control.py --workload hiseq101.batch --seeds 11,12,13

For each seed, in one process: the cell's entry makes its inputs, runs one
call of the timed path as the configuration states it (a sound reading) and
one with the program's Illumina 8-level quality binning switched on (the
control: qualities at a lower precision than the configuration's, which
states whole Phred values), and each output is compared with the plain
reference of the stated configuration (each entry's `control(state)`
switches the path on).  One JSON line per seed and kind gives every
compared number.  The benchmark's own runs never run this.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]

import argparse  # noqa: E402
import json  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

import harness  # noqa: E402


def readings(name: str, seed: int, device: str = "cuda", overrides: dict | None = None,
             kinds=("sound", "control")) -> list:
    """[{"kind", "seed", "checks": {name: value}, "correct"}] for one seed."""
    import torch

    manifest = harness.load_json(ROOT, "BENCHMARK.json")
    cell, config, traffic, entry = harness.load_cell(name, manifest, overrides)
    traffic = dict(traffic, warmup_calls=0)
    out = []
    with tempfile.TemporaryDirectory(prefix="bench-control-") as scratch:
        ctx = harness.Context(cell, config, traffic, seed, device, scratch)
        state = entry.setup(ctx)
        try:
            for kind in kinds:
                if kind == "control":
                    entry.control(state)
                t = time.perf_counter()
                _, output = entry.call(state)
                call_s = time.perf_counter() - t
                checks = entry.check(state, output)
                out.append({"kind": kind, "seed": seed, "call_s": call_s,
                            "checks": {k: v for k, (v, _) in checks.items()},
                            "correct": all(v <= lim for v, lim in checks.values())})
                if device == "cuda":
                    torch.cuda.empty_cache()
        finally:
            entry.close(state)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--kinds", default="sound,control")
    args = p.parse_args(argv)
    harness.use_checkout_caches()  # before torch is imported
    import torch

    if not torch.cuda.is_available():
        print("control: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        for rec in readings(args.workload, seed, kinds=tuple(args.kinds.split(","))):
            print(json.dumps(dict(rec, workload=args.workload)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

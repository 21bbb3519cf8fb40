#!/usr/bin/env python3
"""What the port's spans cost while they are recorded, with no profiler running.

utils/profiling.span records nothing unless a torch.profiler is active or a
`recording()` block is open.  This tool times the benchmark's two kinds of
call with recording on and off, in alternating pairs (on first in even
pairs, off first in odd ones), on the host clock: engine.smooth_fastq on a
batch of the `hiseq101` configuration's reads (the `hiseq101.batch` cell's
batch), and cli.main(IN, -o, BASE, -0) on one FASTQ file of the
`hiseq101.file` cell's reads.  Reads come from the benchmark's own
generator (benchmark/gen/reads.py), from the fixed SEED.  The spans of an "on"
call are read (their CUDA events resolved) and forgotten after its clock
stops.  Prints one JSON line: per kind, each side's call seconds, their
median and quartiles, the median of the per-pair on - off, and per span
name the median of its host and device ms a call, beside the card's name
and power limit.

    python3 tools/span_cost_torch.py [--pairs 10] [--config hiseq101] [--kinds batch,file]
                                     [--reads N] [--file-reads N] [--cpu]

--config names the batch's configuration under benchmark/configs (the file
is always the `hiseq101.file` cell's); --kinds picks the kinds of call.

Without --cpu it needs a card.  Imports nothing of jax or bfqzip_tpu.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "benchmark")]

SEED = 2**31 + 14  # past 32 signed bits, as the benchmark's seeds are


def _summary(on: list, off: list) -> dict:
    def quartiles(v):
        q1, med, q3 = statistics.quantiles(v, n=4)
        return {"median": statistics.median(v), "q1": q1, "q3": q3}

    return {"on_s": on, "off_s": off, "on": quartiles(on), "off": quartiles(off),
            "pair_on_minus_off_median_s": statistics.median(a - b for a, b in zip(on, off))}


def _pairs(run, pairs: int) -> dict:
    """run(record) -> seconds of one call, alternating which side goes first;
    also, per span name, the median over the "on" calls of its summed host
    and device ms in a call."""
    from bfqzip_tpu_torch.utils import profiling

    on, off, per_call = [], [], []
    for i in range(pairs):
        for record in ((True, False) if i % 2 == 0 else (False, True)):
            (on if record else off).append(run(record))
            sums = {}
            for s in profiling.spans():
                got = sums.setdefault(s["name"], {"host_ms": 0.0, "device_ms": 0.0})
                got["host_ms"] += s["host_ms"]
                got["device_ms"] = None if s["device_ms"] is None else got["device_ms"] + s["device_ms"]
            if record:
                per_call.append(sums)
            profiling.clear_spans()
    spans = {name: {k: None if any(c[name][k] is None for c in per_call)
                    else statistics.median(c[name][k] for c in per_call)
                    for k in ("host_ms", "device_ms")} for name in per_call[0]}
    return dict(_summary(on, off), spans=spans)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--pairs", type=int, default=10)
    p.add_argument("--config", default="hiseq101")
    p.add_argument("--kinds", default="batch,file")
    p.add_argument("--reads", type=int, default=None, help="batch reads (the configuration's)")
    p.add_argument("--file-reads", type=int, default=None, help="file reads (the cell's)")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    from bfqzip_tpu_torch.engine import resolve_device
    from bfqzip_tpu_torch.utils import profiling

    dev = resolve_device("cpu" if args.cpu else "cuda")
    kinds = args.kinds.split(",")
    result = {"device": profiling.device_info(dev), "pairs": args.pairs, "config": args.config}
    if "batch" in kinds:
        result["batch"] = _batch(args, dev)
    if "file" in kinds:
        result["file"] = _file(args, dev)
    print(json.dumps(result))
    return 0


def _config(name: str) -> dict:
    with open(os.path.join(ROOT, "benchmark", "configs", name + ".json")) as f:
        return json.load(f)


def _batch(args, dev) -> dict:
    from bfqzip_tpu_torch.config import SmoothConfig
    from bfqzip_tpu_torch.engine import smooth_fastq
    from bfqzip_tpu_torch.io.fastq import ReadBatch
    from bfqzip_tpu_torch.utils.profiling import recording
    from gen import reads as gen

    config = _config(args.config)
    reads = dict(config["reads"], count=args.reads or config["reads"]["count"])
    seqs, quals, lengths = gen.make(reads, SEED, dev)
    batch = ReadBatch(seqs=seqs.cpu().numpy(), quals=quals.cpu().numpy(), lengths=lengths.cpu().numpy())
    del seqs, quals, lengths
    cfg = SmoothConfig(**config["smooth"])

    def call(record: bool) -> float:
        with recording() if record else contextlib.nullcontext():
            t0 = time.perf_counter()
            smooth_fastq(batch, cfg, device=dev)
            return time.perf_counter() - t0

    for _ in range(2):
        call(False)
    return dict(_pairs(call, args.pairs), reads=reads["count"])


def _file(args, dev) -> dict:
    from bfqzip_tpu_torch import cli
    from bfqzip_tpu_torch.utils.profiling import recording
    from gen import reads as gen

    with open(os.path.join(ROOT, "benchmark", "workloads", "hiseq101.file.json")) as f:
        traffic = json.load(f)
    config = _config(traffic["config"])
    reads = dict(config["reads"], count=args.file_reads or traffic["reads"]["count"])
    seqs, quals, lengths = gen.make(reads, SEED, dev)
    with tempfile.TemporaryDirectory(prefix="span-cost-") as work:
        src = os.path.join(work, "in.fastq")
        with open(src, "wb") as f:
            f.write(gen.fastq_bytes(seqs.cpu().numpy(), quals.cpu().numpy()))
        del seqs, quals, lengths
        count = [0]

        def one_file(record: bool) -> float:
            count[0] += 1
            base = os.path.join(work, f"out{count[0]}")
            argv = [src, "-o", base, *traffic["cli_args"]] + (["--cpu"] if args.cpu else [])
            with recording() if record else contextlib.nullcontext():
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(sys.stderr):
                    rc = cli.main(argv)
                seconds = time.perf_counter() - t0
            if rc != 0:
                raise RuntimeError(f"cli.main returned {rc}")
            for path in glob.glob(glob.escape(base) + ".*"):
                os.remove(path)
            return seconds

        one_file(False)
        return dict(_pairs(one_file, args.pairs), reads=reads["count"])


if __name__ == "__main__":
    sys.exit(main())

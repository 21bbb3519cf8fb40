"""End-to-end benchmark of the port's main path: engine.smooth_step.

The counterpart of the repository's bench.py (which runs the JAX package)
for bfqzip_tpu_torch, on the same workload: Illumina-like reads from
tools/make_realistic.make(reads, len, max(reads * len / 34e6, 0.05), 0,
0.005, 0.001) (~34x coverage, 0.5% errors, 0.1% N), or with --uniform
seed-0 uniform-random DNA (almost no clusters), every read at full length,
SmoothConfig().

    python -m bfqzip_tpu_torch.bench [--reads 200000] [--len 101] [--reps 3] [--uniform] [--cpu]

The inputs are placed on the device before any timing; one warm-up
smooth_step, then --reps timed calls, each ending in a synchronisation with
the card.  `value` is the best call's bases per second, `median` the
median call's; `runs_s` holds every call's seconds.  Then build_ebwt,
smooth and invert_via_sa are each warmed up and timed once on the same
inputs (`stages`).  `peak_device_bytes` is torch.cuda.max_memory_allocated
over the timed calls, `seg_scan_launches` the CUDA scan kernel's launches in
each timed call.  `scope` says what is timed: smooth_step on inputs that
already lie on the device, without smooth_fastq's host copies.

Prints one JSON line.  No `vs_baseline`: bench.py's reference rate was
measured on another host, not on this card's.  Without --cpu it needs a
card (utils.profiling.resolve_device raises otherwise).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

from bfqzip_tpu_torch import alphabet
from bfqzip_tpu_torch.config import SmoothConfig
from bfqzip_tpu_torch.convert import batch_to_tensors
from bfqzip_tpu_torch.engine import smooth_step
from bfqzip_tpu_torch.io.fastq import ReadBatch
from bfqzip_tpu_torch.ops import cuda_scan
from bfqzip_tpu_torch.ops.invert import invert_via_sa
from bfqzip_tpu_torch.ops.smooth import smooth
from bfqzip_tpu_torch.ops.suffix import build_ebwt
from bfqzip_tpu_torch.utils.profiling import device_info, resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCOPE = "smooth_step on device-resident inputs"


def workload(n_reads: int, read_len: int, uniform: bool = False) -> ReadBatch:
    """bench.py's reads: realistic, or seed-0 uniform DNA with --uniform."""
    if uniform:
        rng = np.random.default_rng(0)
        bases = np.array([1, 2, 3, 5], dtype=np.uint8)
        seqs = bases[rng.integers(0, 4, size=(n_reads, read_len))]
        quals = (33 + rng.integers(2, 42, size=(n_reads, read_len))).astype(np.uint8)
    else:
        sys.path.insert(0, os.path.join(ROOT, "tools"))
        from make_realistic import make

        genome_mb = max(n_reads * read_len / 34e6, 0.05)  # ~34x coverage
        seq_ascii, quals = make(n_reads, read_len, genome_mb, 0, 0.005, 0.001)
        seqs = alphabet.encode(seq_ascii)
    return ReadBatch(seqs=seqs, quals=quals, lengths=np.full(n_reads, read_len, np.int32))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(batch: ReadBatch, device="cuda", reps: int = 3) -> dict:
    """Time smooth_step on `batch` (see the module docstring); the JSON
    line's fields."""
    dev = resolve_device(device)
    cfg = SmoothConfig()
    seqs, quals, lengths = batch_to_tensors(batch, dev)
    n_reads, width = seqs.shape
    bases = int(batch.lengths.sum())
    _sync(dev)

    smooth_step(seqs, quals, lengths, cfg)  # warm-up
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    runs_s, launches = [], []
    for _ in range(reps):
        before = cuda_scan.launches
        t = time.perf_counter()
        smooth_step(seqs, quals, lengths, cfg)
        _sync(dev)
        runs_s.append(time.perf_counter() - t)
        launches.append(cuda_scan.launches - before)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None

    def timed(fn):
        fn()  # warm-up
        _sync(dev)
        t = time.perf_counter()
        out = fn()
        _sync(dev)
        return out, (time.perf_counter() - t) * 1e3

    ebwt, build_ms = timed(lambda: build_ebwt(seqs, quals, lengths))
    out, smooth_ms = timed(lambda: smooth(ebwt, cfg, pre=ebwt.pre))
    _, invert_ms = timed(lambda: invert_via_sa(ebwt.sa, ebwt.bwt, out.bwt_sub, out.qs, ebwt.n,
                                               n_reads, width, binning=cfg.binning))
    return {
        "metric": "e2e_smooth_bases_per_sec",
        "value": bases / min(runs_s),
        "unit": "bases/s",
        "median": bases / statistics.median(runs_s),
        "runs_s": runs_s,
        "reads": n_reads,
        "read_len": width,
        "stages": {"build_ms": build_ms, "smooth_ms": smooth_ms, "invert_ms": invert_ms},
        "peak_device_bytes": peak,
        "seg_scan_launches": launches,
        "device": device_info(dev),
        "scope": SCOPE,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--reads", type=int, default=200_000)
    ap.add_argument("--len", dest="read_len", type=int, default=101)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--uniform", action="store_true", help="uniform-random DNA (no clusters)")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = ap.parse_args(argv)
    if args.reads <= 0 or args.read_len <= 0 or args.reps <= 0:
        ap.error("--reads, --len and --reps must be positive")
    dev = resolve_device("cpu" if args.cpu else "cuda")
    batch = workload(args.reads, args.read_len, args.uniform)
    print(json.dumps(run(batch, dev, args.reps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

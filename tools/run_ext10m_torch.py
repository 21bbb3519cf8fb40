#!/usr/bin/env python3
"""Drive the PyTorch port's out-of-core pipeline on a FASTQ file.

The counterpart of tools/run_ext10m.py (which runs the JAX package) for
bfqzip_tpu_torch: the reads are parsed into spill-backed host arrays
(io/spill.read_fastq_spill; in RAM with --no-spill) and smoothed by
external.smooth_fastq_external under a device-memory budget of --mem-gb
GiB: chunked device sorts, the native k-way merge, streaming smoothing.
Prints one JSON line with run_ext10m.py's keys (wall time, bases per
second, stage attribution, peak host RSS, changed bases, stats) plus the
device, the peak device bytes above what was allocated before the call
(torch.cuda.max_memory_allocated; null on the CPU), the budget in bytes
and the call's seg_scan kernel launches (0 on the CPU).  The two peak
RSS figures are utils/profiling.RssSampler's, sampled over the parse and
over the parse and the pipeline: getrusage's peak, which run_ext10m.py
prints and external's stage_attribution keeps, includes what a parent
process held when it started this one.

    python3 tools/run_ext10m_torch.py FASTQ [--mem-gb 4] [--out OUT.fq] [--no-spill] [--cpu]

Spill files go to BFQ_SPILL_DIR, else the temporary directory.  Without
--cpu it needs a card.  Imports nothing of jax or bfqzip_tpu.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def run(fastq: str, mem_gb: float, out_path: str | None, spill: bool, device) -> dict:
    import numpy as np
    import torch

    from bfqzip_tpu_torch.engine import resolve_device
    from bfqzip_tpu_torch.external import smooth_fastq_external
    from bfqzip_tpu_torch.io.fastq import read_fastq
    from bfqzip_tpu_torch.io.spill import Spill, read_fastq_spill
    from bfqzip_tpu_torch.ops import cuda_scan
    from bfqzip_tpu_torch.utils.profiling import RssSampler, device_info

    dev = resolve_device(device)
    t0 = time.time()
    with RssSampler() as rss:
        if spill:
            sp = Spill()
            batch = read_fastq_spill(fastq, sp, with_headers=False)
        else:
            sp = False
            batch = read_fastq(fastq, with_headers=False)
    t_parse = time.time() - t0
    rss_parse = rss.peak
    if batch.num_reads == 0:
        raise ValueError("parser returned no reads")
    total_bases = int(batch.lengths.sum())

    budget = int(mem_gb * (1 << 30))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        base_bytes = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    rep = {}
    launches = cuda_scan.launches
    t1 = time.time()
    with RssSampler() as rss:
        out, stats = smooth_fastq_external(batch, mem_bytes=budget, device=dev, spill=sp,
                                           out_path=out_path, report=rep)
    t_pipe = time.time() - t1
    launches = cuda_scan.launches - launches
    peak = torch.cuda.max_memory_allocated(dev) - base_bytes if dev.type == "cuda" else None

    # sanity: same shapes and lengths; count the bases the smoother changed
    if out.seqs.shape[0] != batch.seqs.shape[0] or not np.array_equal(out.lengths, batch.lengths):
        raise RuntimeError("the smoothed batch has other read counts or lengths than the input")
    w = batch.seqs.shape[1]
    changed = 0
    slab = 1 << 20
    for lo in range(0, batch.num_reads, slab):
        hi = min(lo + slab, batch.num_reads)
        changed += int((np.asarray(out.seqs[lo:hi])[:, :w] != np.asarray(batch.seqs[lo:hi])).sum())

    return {
        "metric": "extmem_bases_per_sec",
        "value": total_bases / t_pipe,
        "unit": "bases/s",
        "spill": spill,
        "reads": int(batch.num_reads),
        "total_bases": total_bases,
        "parse_s": t_parse,
        "parse_peak_rss_gb": rss_parse / 1e9,
        "pipeline_s": t_pipe,
        "stage_attribution": rep,
        "peak_host_rss_gb": max(rss_parse, rss.peak) / 1e9,
        "bases_changed": changed,
        "stats": {k: int(v) for k, v in stats.items()},
        "device": device_info(dev),
        "peak_device_bytes": peak,
        "budget_bytes": budget,
        "seg_scan_launches": launches,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("fastq")
    ap.add_argument("--mem-gb", type=float, default=4.0)
    ap.add_argument("--out", default=None, help="optional smoothed FASTQ path")
    ap.add_argument("--no-spill", action="store_true", help="keep the host arrays in RAM")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = ap.parse_args(argv)

    import logging

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    print(json.dumps(run(args.fastq, args.mem_gb, args.out, not args.no_spill,
                         "cpu" if args.cpu else "cuda")))
    return 0


if __name__ == "__main__":
    sys.exit(main())

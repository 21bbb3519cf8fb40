#!/usr/bin/env python3
"""Time the PyTorch port's smoother step by step, with each step's launches.

The counterpart of tools/profile_smooth.py for bfqzip_tpu_torch, for the
smoother both packages run now (ops/smooth.py::smooth):

  cluster_words    predicates, run marks, the per-cluster scans, the
                   decision word at each cluster close
  broadcast_words  the keep-left scan that puts the word on every member
  apply_words      the elementwise apply
  change_counts    the two stats sums
  smooth           the whole smooth(ebwt, cfg, pre=ebwt.pre)

each the best of 3 calls after a warm-up (CUDA events on the card), on the
EBWT of realistic reads (bfqzip_tpu_torch.bench.workload; uniform DNA
forms almost no clusters).  Then each step runs once more under
torch.profiler: its seg_scan launches (ops/cuda_scan.launches), and the
device kernel launches and kernel ms of its trace (null on the CPU, which
has no device timeline).

    python3 tools/profile_smooth_torch.py [--reads N] [--len L] [--cpu] [--trace-dir DIR]

Prints one JSON line.  Without --cpu it needs a card.  Imports nothing of
jax or bfqzip_tpu.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STEPS = ("cluster_words", "broadcast_words", "apply_words", "change_counts")


def profile(batch, device, trace_dir: str) -> dict:
    from bfqzip_tpu_torch import SmoothConfig
    from bfqzip_tpu_torch.convert import batch_to_tensors
    from bfqzip_tpu_torch.engine import resolve_device
    from bfqzip_tpu_torch.ops import cuda_scan
    from bfqzip_tpu_torch.ops.scan import LOCAL_OPS as ops
    from bfqzip_tpu_torch.ops.smooth import (apply_words, broadcast_words, change_counts,
                                             cluster_words, smooth)
    from bfqzip_tpu_torch.ops.suffix import build_ebwt
    from bfqzip_tpu_torch.utils.profiling import PhaseProfiler, best_ms, device_info, device_timeline

    dev = resolve_device(device)
    cfg = SmoothConfig()
    seqs, quals, lengths = batch_to_tensors(batch, dev)
    n_reads, width = seqs.shape
    ebwt = build_ebwt(seqs, quals, lengths)
    del seqs, quals, lengths
    bwt, qs, lcp, n, pre = ebwt.bwt, ebwt.qs, ebwt.lcp, ebwt.n, ebwt.pre
    word, close_mark, in_cluster, _ = cluster_words(bwt, qs, lcp, n, cfg, pre, ops)
    w = broadcast_words(word, close_mark, ops)
    _, _, modified, qs_smoothed = apply_words(bwt, qs, pre, w, in_cluster, cfg)
    calls = {
        "cluster_words": lambda: cluster_words(bwt, qs, lcp, n, cfg, pre, ops),
        "broadcast_words": lambda: broadcast_words(word, close_mark, ops),
        "apply_words": lambda: apply_words(bwt, qs, pre, w, in_cluster, cfg),
        "change_counts": lambda: change_counts(modified, qs_smoothed, ops),
        "smooth": lambda: smooth(ebwt, cfg, pre=pre),
    }

    prof = PhaseProfiler(trace_dir=trace_dir, device=dev)
    out = {}
    for name, fn in calls.items():
        ms = best_ms(fn, dev)
        before = cuda_scan.launches
        with prof.trace(name):
            fn()
        launches = cuda_scan.launches - before
        kernels = device_timeline(prof.trace_path, name)["kernels"]
        out[name] = {
            "ms": ms, "seg_scan_launches": launches,
            "kernel_launches": None if kernels is None else sum(k["launches"] for k in kernels.values()),
            "kernel_ms": None if kernels is None else sum(k["ms"] for k in kernels.values()),
        }
    return {
        "device": device_info(dev), "reads": n_reads, "read_len": width, "n_pad": int(bwt.shape[0]),
        "steps": {k: out[k] for k in STEPS}, "smooth": out["smooth"],
        "sum_steps_ms": sum(out[k]["ms"] for k in STEPS), "trace_dir": trace_dir,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--reads", type=int, default=200_000)
    ap.add_argument("--len", dest="read_len", type=int, default=101)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--trace-dir", default=os.path.join(ROOT, "build", "profile_smooth_torch"),
                    help="where the Chrome traces of the steps are written")
    args = ap.parse_args(argv)

    from bfqzip_tpu_torch.bench import workload
    from bfqzip_tpu_torch.engine import resolve_device

    dev = resolve_device("cpu" if args.cpu else "cuda")
    print(json.dumps(profile(workload(args.reads, args.read_len), dev, args.trace_dir)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Per-stage timing and a device timeline of the PyTorch port's main path.

The counterpart of tools/profile_stages.py (which times the JAX package) for
bfqzip_tpu_torch: realistic reads from tools/make_realistic.make (4.6 Mb
genome, seed 0, 0.5% errors, 0.1% N) through ops/suffix.build_ebwt,
ops/smooth.smooth and ops/invert.invert_via_sa, each the best of 3 timed
calls after a warm-up (host clock, synchronised with the card at both
ends).  Then one more engine.smooth_step runs under
utils/profiling.PhaseProfiler.trace(), and its Chrome trace gives the top 10
device kernels by total device time (share: of all kernel time), the total
kernel ms and launches, the seg_scan kernel's launches, the
device-busy ms (kernel, copy and fill intervals, overlaps merged) and the
idle share: 1 - busy / the call's wall span.  On the CPU there is no device
timeline: busy, idle share and kernels are null.  Prints one JSON line.

    python3 tools/profile_stages_torch.py [--reads N] [--len L] [--cpu] [--trace-dir DIR]

Without --cpu it needs a card.  Imports nothing of jax or bfqzip_tpu.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

# the user annotation that marks the traced call in the Chrome trace
REGION = "smooth_step"
# the seg_scan kernel's name in a trace (csrc/seg_scan.cu): one scan_tiles
# launch per integer scan
SEG_SCAN_KERNEL = "scan_tiles"
TOP = 10
REPS = 3  # timed calls per stage, after one warm-up


def realistic_batch(n_reads: int, read_len: int):
    import numpy as np

    from bfqzip_tpu_torch.io import ReadBatch, encode
    from make_realistic import make

    seq_ascii, quals = make(n_reads, read_len, 4.6, 0, 0.005, 0.001)
    return ReadBatch(seqs=encode(seq_ascii), quals=quals, lengths=np.full(n_reads, read_len, np.int32))


def profile_batch(batch, device, trace_dir: str) -> dict:
    """Stage times of `batch` on `device` and the timeline of one traced
    smooth_step, whose Chrome trace is written into `trace_dir` (see the
    module docstring)."""
    from bfqzip_tpu_torch import SmoothConfig
    from bfqzip_tpu_torch.convert import batch_to_tensors
    from bfqzip_tpu_torch.engine import resolve_device, smooth_step
    from bfqzip_tpu_torch.ops import cuda_scan
    from bfqzip_tpu_torch.ops.invert import invert_via_sa
    from bfqzip_tpu_torch.ops.smooth import smooth
    from bfqzip_tpu_torch.ops.suffix import build_ebwt
    from bfqzip_tpu_torch.utils.profiling import PhaseProfiler, device_timeline

    dev = resolve_device(device)
    prof = PhaseProfiler(trace_dir=trace_dir, device=dev)
    cfg = SmoothConfig()
    seqs, quals, lengths = batch_to_tensors(batch, dev)
    n_reads, width = seqs.shape
    bases = int(batch.lengths.sum())

    def best_ms(name, fn):
        out = fn()  # warm-up
        for _ in range(REPS):
            with prof.phase(name):
                out = fn()
        return out, min(r["seconds"] for r in prof.records if r["phase"] == name) * 1e3

    ebwt, build_ms = best_ms("build_ebwt", lambda: build_ebwt(seqs, quals, lengths))
    sm, smooth_ms = best_ms("smooth", lambda: smooth(ebwt, cfg, pre=ebwt.pre))
    _, invert_ms = best_ms("invert_via_sa", lambda: invert_via_sa(
        ebwt.sa, ebwt.bwt, sm.bwt_sub, sm.qs, ebwt.n, n_reads, width, binning=cfg.binning))
    del ebwt, sm
    stages = {"build_ebwt": build_ms, "smooth": smooth_ms, "invert_via_sa": invert_ms}
    total_ms = sum(stages.values())

    before = cuda_scan.launches
    with prof.trace(REGION):
        smooth_step(seqs, quals, lengths, cfg)
    res = {
        "device": str(dev), "reads": n_reads, "read_len": width, "bases": bases,
        "stages_ms": stages, "stages_share": {k: v / total_ms for k, v in stages.items()},
        "bases_per_s": {**{k: bases / (v / 1e3) for k, v in stages.items()},
                        "total": bases / (total_ms / 1e3)},
        "seg_scan_launches": cuda_scan.launches - before, "trace": prof.trace_path,
        "kernel_ms": None, "kernel_launches": None, "seg_scan_kernels": None, "top_kernels": None,
    }
    tl = device_timeline(prof.trace_path, REGION)
    res.update(span_ms=tl["span_ms"], busy_ms=tl["busy_ms"], idle_share=tl["idle_share"])
    if tl["kernels"] is not None:
        kernel_ms = sum(k["ms"] for k in tl["kernels"].values())
        top = sorted(tl["kernels"].items(), key=lambda kv: -kv[1]["ms"])[:TOP]
        res["kernel_ms"] = kernel_ms
        res["kernel_launches"] = sum(k["launches"] for k in tl["kernels"].values())
        res["top_kernels"] = [{"name": name[:160], "launches": k["launches"], "ms": k["ms"],
                               "share": k["ms"] / kernel_ms} for name, k in top]
        res["seg_scan_kernels"] = sum(k["launches"] for name, k in tl["kernels"].items()
                                      if SEG_SCAN_KERNEL in name)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--reads", type=int, default=200_000)
    ap.add_argument("--len", dest="read_len", type=int, default=101)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--trace-dir", default=os.path.join(ROOT, "build", "profile_stages_torch"),
                    help="where the Chrome trace is written")
    args = ap.parse_args(argv)
    batch = realistic_batch(args.reads, args.read_len)
    res = profile_batch(batch, "cpu" if args.cpu else "cuda", args.trace_dir)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

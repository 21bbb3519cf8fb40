#!/usr/bin/env python3
"""Cross-chunk stage overlap on one card: one smooth_step over the whole
batch against the batch cut into C chunks, each an EBWT of its own.

The counterpart of tools/exp_overlap.py (which dispatches jitted stages)
for bfqzip_tpu_torch, on bench.workload's reads (200K x 101 bp by
default) and SmoothConfig():

  fused_1chunk          engine.smooth_step on the whole batch
  chunked_C_overlap     per chunk, build_ebwt -> smooth(e, cfg,
                        pre=pre_of(e)) -> invert_via_sa, all queued on the
                        current stream with no synchronisation until the end
  chunked_C_serial      the same with torch.cuda.synchronize() after every
                        stage, so the host enqueues each stage only once the
                        card has finished the one before (on the CPU,
                        where nothing is queued, the same as overlap)

for C in 2 and 4 (the JAX tool's configurations; one stream, as there).
Each is the best of --reps calls after a warm-up (utils/profiling.best_ms:
CUDA events on the card), with its bases per second;
`chunked_C_enqueue_ms` is the host's time to queue one overlapped run
(host clock, from an idle card to the last launch's return), which bounds
it from below when the host, not the card, sets the pace.  Each chunk is its own
EBWT (the reference's block semantics), so its smoothed reads must equal
engine.smooth_fastq of that chunk: `chunks_equal`.  A stage triple
launches the seg_scan kernel 5 times (`launches_per_stage_triple`, counted
in one chunked run); `seg_scan_launches` counts the whole run.

    python3 tools/exp_overlap_torch.py [--reads 200000] [--len 101] [--reps 3] [--cpu]

Prints one JSON line naming the device with its power limit.  Without
--cpu it needs a card.  Imports nothing of jax or bfqzip_tpu.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bfqzip_tpu_torch import SmoothConfig  # noqa: E402
from bfqzip_tpu_torch.bench import workload  # noqa: E402
from bfqzip_tpu_torch.convert import batch_to_tensors  # noqa: E402
from bfqzip_tpu_torch.engine import pre_of, resolve_device, smooth_fastq, smooth_step  # noqa: E402
from bfqzip_tpu_torch.io.fastq import ReadBatch  # noqa: E402
from bfqzip_tpu_torch.ops import cuda_scan  # noqa: E402
from bfqzip_tpu_torch.ops.invert import invert_via_sa  # noqa: E402
from bfqzip_tpu_torch.ops.smooth import smooth  # noqa: E402
from bfqzip_tpu_torch.ops.suffix import build_ebwt  # noqa: E402
from bfqzip_tpu_torch.utils.profiling import best_ms, device_info  # noqa: E402

CHUNKS = (2, 4)


def chunked(chunks: list, cfg: SmoothConfig, sync: bool) -> list:
    """build -> smooth -> invert per chunk, each stage queued on the current
    stream; sync: wait for the card after every stage."""
    def stage_done():
        if sync:
            torch.cuda.synchronize()

    outs = []
    for seqs, quals, lengths in chunks:
        n_reads, width = seqs.shape
        e = build_ebwt(seqs, quals, lengths)
        stage_done()
        o = smooth(e, cfg, pre=pre_of(e))
        stage_done()
        outs.append(invert_via_sa(e.sa, e.bwt, o.bwt_sub, o.qs, e.n, n_reads, width,
                                  binning=cfg.binning))
        stage_done()
    return outs


def run(batch: ReadBatch, device, reps: int = 3) -> dict:
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    cfg = SmoothConfig()
    launches0 = cuda_scan.launches
    n_reads, width = batch.seqs.shape
    seqs, quals, lengths = batch_to_tensors(batch, dev)
    res = {"device": device_info(dev), "reads": n_reads, "read_len": width, "reps": reps}

    def timed(name: str, fn, reads: int):
        ms = best_ms(fn, dev, reps)
        res[f"{name}_ms"] = ms
        res[f"{name}_mbases_per_s"] = int(batch.lengths[:reads].sum()) / ms / 1e3

    timed("fused_1chunk", lambda: smooth_step(seqs, quals, lengths, cfg), n_reads)
    equal, per_triple = True, set()
    for c in CHUNKS:
        per = n_reads // c
        chunks = [(seqs[i * per:(i + 1) * per], quals[i * per:(i + 1) * per],
                   lengths[i * per:(i + 1) * per]) for i in range(c)]
        timed(f"chunked_{c}_overlap", lambda: chunked(chunks, cfg, sync=False), c * per)
        timed(f"chunked_{c}_serial", lambda: chunked(chunks, cfg, sync=on_card), c * per)
        before = cuda_scan.launches
        if on_card:
            torch.cuda.synchronize()
        t = time.perf_counter()
        outs = chunked(chunks, cfg, sync=False)
        res[f"chunked_{c}_enqueue_ms"] = (time.perf_counter() - t) * 1e3
        per_triple.add((cuda_scan.launches - before) // c)
        for i, inv in enumerate(outs):
            sl = slice(i * per, (i + 1) * per)
            part = ReadBatch(seqs=batch.seqs[sl], quals=batch.quals[sl], lengths=batch.lengths[sl])
            want, _ = smooth_fastq(part, cfg, device=dev)
            equal &= (np.array_equal(inv.seqs.cpu().numpy(), want.seqs)
                      and np.array_equal(inv.quals.cpu().numpy(), want.quals)
                      and np.array_equal(inv.lengths.cpu().numpy(), want.lengths))
    res.update({"chunks_equal": bool(equal), "launches_per_stage_triple": sorted(per_triple),
                "seg_scan_launches": cuda_scan.launches - launches0})
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--reads", type=int, default=200_000)
    ap.add_argument("--len", dest="read_len", type=int, default=101)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = ap.parse_args(argv)
    dev = resolve_device("cpu" if args.cpu else "cuda")
    print(json.dumps(run(workload(args.reads, args.read_len), dev, args.reps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Benchmark the port's k-way suffix merge (csrc/extmerge.cpp) on chunk
orders sorted on the card.

The counterpart of tools/bench_extmerge.py for bfqzip_tpu_torch.  The first
--reads reads of the FASTQ (all by default) are cut into --chunks chunks;
each is sorted by the port's build on the card, as the out-of-core path
sorts its chunks (external._sort_chunk).  The port's merge is then timed on
the same orders: on --threads threads (0: one per core, BFQ_EXT_THREADS
overrides) and on one, with the chunk LCPs (the LCP loser tree) and without
(the word-wise tree); all outputs must be equal.  Then the live merge
(utils/native.ext_merge_async) runs with one range per thread and with
eight, the default: each run prints when its merged prefix reached 25, 50,
75 and 100% of the positions, while a consumer compares, each time the
prefix grows, a sample of the positions below it with the serial merge's
outputs.  bench_extmerge.py's comparison with a merge compiled from git
history is left out.

Prints one JSON line: `value` is the threaded LCP merge's positions per
second; then each variant's seconds, the live runs, the host's CPU counts,
and the card's name and power limit (the device, with --cpu).

    python3 tools/bench_extmerge_torch.py FASTQ [--reads N] [--chunks 16] [--threads 0] [--cpu]

Without --cpu it needs a card.  Imports nothing of jax or bfqzip_tpu.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SAMPLE = 4096  # positions compared each time the live prefix grows


def _live(inputs, serial, threads: int, ranges: int) -> dict:
    """One live merge with a consumer that checks samples of the final prefix."""
    import numpy as np

    from bfqzip_tpu_torch.utils import native

    text, qtext, sa_chunks, lcp_all = inputs
    rng = np.random.default_rng(0)
    t = time.perf_counter()
    h = native.ext_merge_async(text, qtext, sa_chunks, threads, lcp_all, ranges=ranges)
    checked = polls = last = 0
    while not h.finished(0.001):
        polls += 1
        p = h.merged_prefix()
        if p < last:
            raise RuntimeError(f"the merged prefix went back from {last} to {p}")
        if p > last:
            idx = np.concatenate([rng.integers(last, p, SAMPLE), np.arange(max(last, p - 64), p)])
            for got, want in zip(h.outputs, serial):
                if not np.array_equal(got[idx], want[idx]):
                    raise RuntimeError(f"a position below the merged prefix {p} is not final")
            checked += idx.size
            last = p
    h.join()
    seconds = time.perf_counter() - t
    for got, want in zip(h.outputs, serial):
        if not np.array_equal(got, want):
            raise RuntimeError("the live merge differs from the serial merge")
    return {"threads": threads, "ranges": ranges, "seconds": seconds, "polls": polls,
            "prefix_s": {str(f): s for f, s in h.prefix_s.items()},
            "final_prefix_checked": checked}


def run(fastq: str, reads: int, chunks: int, threads: int, device) -> dict:
    import numpy as np

    from bfqzip_tpu_torch.engine import resolve_device
    from bfqzip_tpu_torch.external import _sort_chunk
    from bfqzip_tpu_torch.io.fastq import ReadBatch, read_fastq
    from bfqzip_tpu_torch.utils import native
    from bfqzip_tpu_torch.utils.profiling import device_info

    dev = resolve_device(device)
    batch = read_fastq(fastq, with_headers=False)
    if reads:
        batch = ReadBatch(seqs=batch.seqs[:reads], quals=batch.quals[:reads], lengths=batch.lengths[:reads])
    n, w = batch.seqs.shape
    wp = w + 1
    k = np.arange(wp)[None, :]
    text = np.where(k < batch.lengths[:, None],
                    np.pad(batch.seqs, ((0, 0), (0, 1))).astype(np.uint8) + 1, 0).reshape(-1)
    qtext = np.pad(batch.quals, ((0, 0), (0, 1))).reshape(-1)
    bounds = np.linspace(0, n, chunks + 1).astype(int)
    t = time.perf_counter()
    sa_parts, lcp_parts = [], []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        sa_c, lcp_c = _sort_chunk(batch, int(lo), int(hi), dev)
        sa_parts.append((sa_c.astype(np.int64) + lo * wp).astype(np.int32))
        lcp_parts.append(lcp_c)
    sort_s = time.perf_counter() - t
    sa_all = np.concatenate(sa_parts)
    offs = np.concatenate([[0], np.cumsum([p.size for p in sa_parts])]).astype(np.int64)
    lcp_all = np.concatenate(lcp_parts)
    total = int(offs[-1])
    threads = native._merge_threads(threads)

    def timed(t_count, lcp):
        t0 = time.perf_counter()
        out = native.ext_merge(text, qtext, (sa_all, offs), lcp, threads=t_count)
        return time.perf_counter() - t0, out

    res = {}
    res["lcptree_threaded_s"], serial = timed(threads, lcp_all)
    variants = {"lcptree_1thread_s": (1, lcp_all), "wordcmp_threaded_s": (threads, None),
                "wordcmp_1thread_s": (1, None)}
    for key, (t_count, lcp) in variants.items():
        res[key], out = timed(t_count, lcp)
        for a, b in zip(serial, out):
            if not np.array_equal(a, b):
                raise RuntimeError(f"merge variants disagree ({key})")
    inputs = (text, qtext, (sa_all, offs), lcp_all)
    live = {"one_range_per_thread": _live(inputs, serial, threads, threads),
            "eight_ranges_per_thread": _live(inputs, serial, threads, 8 * threads)}
    return {
        "metric": "extmerge_positions_per_sec",
        "value": total / res["lcptree_threaded_s"],
        "unit": "positions/s",
        "positions": total,
        "reads": int(n),
        "chunks": chunks,
        "threads": threads,
        "cpu_count": os.cpu_count(),
        "cpu_affinity": len(os.sched_getaffinity(0)),
        "chunk_sort_s": sort_s,
        **res,
        "all_equal": True,
        "live": live,
        "device": device_info(dev),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("fastq")
    ap.add_argument("--reads", type=int, default=0, help="the first N reads (0: all)")
    ap.add_argument("--chunks", type=int, default=16)
    ap.add_argument("--threads", type=int, default=0, help="merge threads (0: one per core)")
    ap.add_argument("--cpu", action="store_true", help="sort the chunks on the CPU instead of the card")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.fastq, args.reads, args.chunks, args.threads, "cpu" if args.cpu else "cuda")))
    return 0


if __name__ == "__main__":
    sys.exit(main())

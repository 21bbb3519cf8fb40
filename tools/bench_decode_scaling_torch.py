#!/usr/bin/env python3
"""BQZC decode thread scaling: measured where the host has the cores,
modelled beyond, through the port's bindings.

The counterpart of tools/bench_decode_scaling.py (which calls the JAX
package's bfqzip_tpu.utils.native) for bfqzip_tpu_torch.  Blocks are
independent (a fresh model per block, disjoint output ranges), so a
k-thread decode's makespan is an LPT schedule of the per-block decode
times.  For the DNA and QS streams of BENCH_READS (default 100000)
realistic 101 bp reads (make(n, 101, max(n * 101 / 34e6, 0.05), 0, 0.005,
0.001), one newline-ended line per read):

  1. encode with 256K-symbol blocks (~40 blocks at 100K reads), through
     bfqzip_tpu_torch.utils.native.cm_encode(stream, block_size=1 << 18);
  2. decode on 1 thread (BFQ_CM_THREADS=1), the best of 2 calls after a
     warm-up (utils/profiling.best_ms on the host clock), recording each
     block's decode time (BFQ_CM_BLOCKTIME, native/cm_codec.cpp) in every
     call and keeping the first timed call's;
  3. decode the same way on 2 threads, and on 4 and 8 where the process
     may use that many cores, each against its LPT prediction;
  4. model the makespan at 1, 2, 4, 8, 16 and 32 threads.

Every decode, warm-ups included, is held against the stream byte for byte;
a difference raises.  The line names the host (CPU model, cores) and,
where the machine has a card, the card with its power limit.

    BENCH_READS=100000 python3 tools/bench_decode_scaling_torch.py

Prints one JSON line.  Imports nothing of jax or bfqzip_tpu.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np
import torch

TOOLS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(TOOLS))
sys.path.insert(0, TOOLS)

from bfqzip_tpu_torch.utils import native  # noqa: E402
from bfqzip_tpu_torch.utils.profiling import best_ms, device_info, host_info  # noqa: E402

BLOCK = 1 << 18
MEASURED = (1, 2, 4, 8)
MODELLED = (1, 2, 4, 8, 16, 32)
TIMED = 2  # timed decodes per thread count, after one warm-up


def lpt_makespan(times, k):
    """The makespan of the times on k workers, longest first, each to the
    least loaded worker."""
    bins = [0.0] * k
    for t in sorted(times, reverse=True):
        i = min(range(k), key=bins.__getitem__)
        bins[i] += t
    return max(bins)


def _decode(blob: bytes, stream: bytes, threads: int, bt_path=None) -> None:
    env = {"BFQ_CM_THREADS": str(threads), "BFQ_CM_BLOCKTIME": bt_path}
    old = {k: os.environ.get(k) for k in env}
    try:
        for k, v in env.items():
            if v is not None:
                os.environ[k] = v
        out = native.cm_decode(blob)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if out is None or out.tobytes() != stream:
        raise RuntimeError(f"decode on {threads} threads differs from the stream")


def measure(stream: bytes, name: str, block_size: int = BLOCK) -> dict:
    blob = native.cm_encode(stream, block_size=block_size)
    cores = len(os.sched_getaffinity(0))
    threads = [k for k in MEASURED if k <= max(cores, 2)]
    fd, bt_path = tempfile.mkstemp(suffix=".bt")
    os.close(fd)
    try:
        secs = {1: best_ms(lambda: _decode(blob, stream, 1, bt_path), "cpu", TIMED) / 1e3}
        with open(bt_path) as f:
            ns = [int(x) for x in f.read().split()]
    finally:
        os.unlink(bt_path)
    calls = TIMED + 1
    if len(ns) % calls:
        raise RuntimeError(f"{len(ns)} block times from {calls} decodes")
    nblocks = len(ns) // calls
    block_s = [v / 1e9 for v in ns[nblocks:2 * nblocks]]  # the first timed call's
    for k in threads[1:]:
        secs[k] = best_ms(lambda: _decode(blob, stream, k), "cpu", TIMED) / 1e3
    mb = len(stream) / 1e6
    model = {k: lpt_makespan(block_s, k) for k in MODELLED}
    return {
        "stream": name,
        "raw_mb": mb,
        "compressed_b": len(blob),
        "nblocks": nblocks,
        "measured_s": {str(k): v for k, v in secs.items()},
        "measured_mbps": {str(k): mb / v for k, v in secs.items()},
        "model_s": {str(k): v for k, v in model.items()},
        "model_vs_measured": {str(k): model[k] / secs[k] for k in secs if k > 1},
        "modelled_mbps": {str(k): mb / v for k, v in model.items()},
        "decodes_checked": calls * len(secs),
        "byte_equal": True,
    }


def run(n_reads: int) -> dict:
    if not native.cm_available():
        raise RuntimeError("the native codec library (make -C native) is not available")
    from make_realistic import make

    seq, qs = make(n_reads, 101, max(n_reads * 101 / 34e6, 0.05), 0, 0.005, 0.001)
    nl = np.full((n_reads, 1), ord("\n"), np.uint8)
    card = device_info("cuda" if torch.cuda.is_available() else "cpu")
    streams = [measure(np.concatenate([rows, nl], axis=1).tobytes(), name)
               for rows, name in ((seq, "dna"), (qs, "qs"))]
    return {"host": host_info(), "device": card, "reads": n_reads, "block_size": BLOCK,
            "streams": streams}


def main() -> int:
    print(json.dumps(run(int(os.environ.get("BENCH_READS", 100_000)))))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""BQZC encode / decode speed and ratio on the realistic workload's streams,
through the port's bindings.

The counterpart of tools/bench_cm.py (which calls the JAX package's
bfqzip_tpu.utils.native) for bfqzip_tpu_torch: the same streams (the
sequences and the qualities of make(reads, len, max(reads * len / 34e6,
0.05), 0, 0.005, 0.001), one newline-ended line per read, cached under
build/bench_cm/) through bfqzip_tpu_torch.utils.native.cm_encode(stream,
block_size=--block, threads=1, pos_reset=) and cm_decode on one thread
(BFQ_CM_THREADS=1).  Per stream: raw and compressed bytes, the encode's MB/s
(one call, host clock) and the decode's (the best of --reps calls after a
warm-up, utils/profiling.best_ms on the host clock); every decode is held
against the stream.

The codec runs on the host, so the line names the host (CPU model, cores)
and, where the machine has a card, the card with its power limit.

    python3 tools/bench_cm_torch.py [--reads 100000] [--len 101] [--block 0] [--reps 3]

Prints one JSON line.  Imports nothing of jax or bfqzip_tpu.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

TOOLS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TOOLS)
sys.path.insert(0, ROOT)
sys.path.insert(0, TOOLS)

from bfqzip_tpu_torch.utils import native  # noqa: E402
from bfqzip_tpu_torch.utils.profiling import best_ms, device_info, host_info  # noqa: E402

CACHE = os.path.join(ROOT, "build", "bench_cm")  # gitignored


def load_streams(reads: int, read_len: int, cache_dir: str = CACHE) -> tuple:
    """(DNA, QS) streams of the realistic reads, written to cache_dir once."""
    os.makedirs(cache_dir, exist_ok=True)
    dna_p = os.path.join(cache_dir, f"dna_{reads}x{read_len}.raw")
    qs_p = os.path.join(cache_dir, f"qs_{reads}x{read_len}.raw")
    if not (os.path.exists(dna_p) and os.path.exists(qs_p)):
        from make_realistic import make

        seq_ascii, quals = make(reads, read_len, max(reads * read_len / 34e6, 0.05), 0, 0.005, 0.001)
        nl = np.full((reads, 1), ord("\n"), np.uint8)
        for path, rows in ((dna_p, seq_ascii), (qs_p, quals)):
            with open(path + ".part", "wb") as f:
                f.write(np.concatenate([rows, nl], axis=1).tobytes())
            os.replace(path + ".part", path)
    with open(dna_p, "rb") as f, open(qs_p, "rb") as g:
        return f.read(), g.read()


def decode_1t(blob: bytes) -> np.ndarray:
    """cm_decode on one thread (BFQ_CM_THREADS=1 for the call)."""
    old = os.environ.get("BFQ_CM_THREADS")
    os.environ["BFQ_CM_THREADS"] = "1"
    try:
        return native.cm_decode(blob)
    finally:
        if old is None:
            os.environ.pop("BFQ_CM_THREADS", None)
        else:
            os.environ["BFQ_CM_THREADS"] = old


def run(reads: int, read_len: int, block: int = 0, reps: int = 3) -> dict:
    if not native.cm_available():
        raise RuntimeError("the native codec library (make -C native) is not available")
    dna, qs = load_streams(reads, read_len)
    card = device_info("cuda" if torch.cuda.is_available() else "cpu")
    out = {"host": host_info(), "device": card, "reads": reads, "read_len": read_len,
           "block_size": block, "reps": reps}
    for name, stream, pos_reset in (("dna", dna, -1), ("qs", qs, ord("\n"))):
        t = time.perf_counter()
        blob = native.cm_encode(stream, block_size=block, threads=1, pos_reset=pos_reset)
        enc_s = time.perf_counter() - t
        if decode_1t(blob).tobytes() != stream:
            raise RuntimeError(f"{name}: the decoded stream differs from the input")
        dec_ms = best_ms(lambda: decode_1t(blob), "cpu", reps)
        mb = len(stream) / 1e6
        out[name] = {"raw": len(stream), "compressed": len(blob), "ratio": len(stream) / len(blob),
                     "enc_mb_s": mb / enc_s, "dec_mb_s_1t": mb / (dec_ms / 1e3), "byte_equal": True}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--reads", type=int, default=100_000)
    ap.add_argument("--len", dest="read_len", type=int, default=101)
    ap.add_argument("--block", type=int, default=0, help="block size (0: the codec's default)")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    print(json.dumps(run(args.reads, args.read_len, args.block, args.reps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

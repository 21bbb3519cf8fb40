#!/usr/bin/env python3
"""Time the PyTorch port's flat EBWT build piece by piece, beside each
piece's memory bound.

The counterpart of tools/profile_build.py (which times the JAX package) for
bfqzip_tpu_torch.  It times the production steps of
ops/suffix.py::_build_ebwt_flat, called as the build calls them, never a
copy of them:

  pack  _pack(seqs, lens): base-6 window words, the padding key
  sort  _sort_lsd(words): the LSD stable sorts and the key gathers
  post  _post(seqs, quals, lens, sa, n): text, BWT, QS and pre through SA
  lcp   _lcp(skeys, sa, lens, wp, valid): the adjacent-key LCP

and the whole build_ebwt, each the best of 3 calls after a warm-up (CUDA
events on the card).  Reads: bfqzip_tpu_torch.bench.workload (realistic,
tools/make_realistic.py).

Bytes: each input read once and each output written once, for N reads of
width L, wp = L + 1, P = N * wp positions and W = ceil(wp / 24) key words:

  pack  N*L (seqs) + 8N (lens) in; 8WP (words) out
  sort  8WP (words) in; 8P (sa) + 8WP (sorted keys) out
  post  2N*L (seqs, quals) + 8N (lens) + 8P (sa) + 4 (n) in;
        5P (bwt, qs, pre, text, valid) out
  lcp   8WP (sorted keys) + 8P (sa) + 8N (lens) + P (valid) in; 4P (lcp) out
  full  2N*L (seqs, quals) + 4N (lengths) in;
        12P (bwt, qs, pre, text u8; lcp, sa i32) + 4 (n) out

The sort's per-pass model (tools/profile_build.py's): each of the W LSD
passes reads and writes an int64 key and an int64 index once, 32WP bytes in
all.  A bound in ms is the bytes over the card's memory rate, looked up by
card name (3.35 TB/s for the NVIDIA H100 80GB HBM3, NVIDIA's data sheet);
an unknown card, or the CPU, gets null.

    python3 tools/profile_build_torch.py [--reads N] [--len L] [--cpu] [--trace DIR]

--trace DIR writes a torch.profiler Chrome trace of one whole build there.
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

# device memory bytes per second by card name (NVIDIA's data sheets)
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}
PIECES = ("pack", "sort", "post", "lcp")


def piece_bytes(n_reads: int, width: int) -> dict:
    """Each piece's bytes, and the whole build's (see the module docstring)."""
    wp = width + 1
    P = n_reads * wp
    W = -(-wp // 24)
    N, NL = n_reads, n_reads * width
    return {
        "pack": NL + 8 * N + 8 * W * P,
        "sort": 8 * W * P + 8 * P + 8 * W * P,
        "post": 2 * NL + 8 * N + 8 * P + 4 + 5 * P,
        "lcp": 8 * W * P + 8 * P + 8 * N + P + 4 * P,
        "full": 2 * NL + 4 * N + 12 * P + 4,
    }


def profile(batch, device, trace_dir: str | None = None) -> dict:
    from bfqzip_tpu_torch.convert import batch_to_tensors
    from bfqzip_tpu_torch.engine import resolve_device
    from bfqzip_tpu_torch.ops import suffix
    from bfqzip_tpu_torch.utils.profiling import PhaseProfiler, best_ms, device_info

    dev = resolve_device(device)
    seqs, quals, lengths = batch_to_tensors(batch, dev)
    n_reads, width = seqs.shape
    if suffix.build_route(width) != "flat":
        raise ValueError(f"width {width} takes the doubling build; this tool splits the flat one")
    wp = width + 1
    lens, n = suffix._lens_and_n(lengths)
    words = suffix._pack(seqs, lens)
    sa, skeys = suffix._sort_lsd(words)
    valid = suffix._post(seqs, quals, lens, sa, n)[-1]
    ms = {
        "pack": best_ms(lambda: suffix._pack(seqs, lens), dev),
        "sort": best_ms(lambda: suffix._sort_lsd(words), dev),
        "post": best_ms(lambda: suffix._post(seqs, quals, lens, sa, n), dev),
        "lcp": best_ms(lambda: suffix._lcp(skeys, sa, lens, wp, valid), dev),
    }
    n_words = len(words)
    del words, sa, skeys, valid
    full_ms = best_ms(lambda: suffix.build_ebwt(seqs, quals, lengths), dev)

    info = device_info(dev)
    rate = HBM_BYTES_PER_S.get(info["name"]) if dev.type == "cuda" else None
    nbytes = piece_bytes(n_reads, width)

    def bound(b):
        return b / rate * 1e3 if rate else None

    total = sum(ms.values())
    n_pad = n_reads * wp
    model_bytes = 32 * n_words * n_pad
    res = {
        "device": info, "reads": n_reads, "read_len": width, "n_pad": n_pad, "n_words": n_words,
        "bandwidth_bytes_per_s": rate,
        "pieces": {k: {"ms": ms[k], "bytes": nbytes[k], "bound_ms": bound(nbytes[k]),
                       "share_of_full": ms[k] / full_ms} for k in PIECES},
        "full_build": {"ms": full_ms, "bytes": nbytes["full"], "bound_ms": bound(nbytes["full"])},
        "sum_pieces_ms": total, "sum_over_full": total / full_ms,
        "sort_lsd_model": {"passes": n_words, "bytes": model_bytes, "bound_ms": bound(model_bytes),
                           "effective_bytes_per_s": model_bytes / (ms["sort"] / 1e3)},
        "trace": None,
    }
    if trace_dir:
        prof = PhaseProfiler(trace_dir=trace_dir, device=dev)
        with prof.trace("build_ebwt"):
            suffix.build_ebwt(seqs, quals, lengths)
        res["trace"] = prof.trace_path
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--reads", type=int, default=200_000)
    ap.add_argument("--len", dest="read_len", type=int, default=101)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--trace", default=None, help="write a Chrome trace of one whole build here")
    args = ap.parse_args(argv)

    from bfqzip_tpu_torch.bench import workload
    from bfqzip_tpu_torch.engine import resolve_device

    dev = resolve_device("cpu" if args.cpu else "cuda")
    print(json.dumps(profile(workload(args.reads, args.read_len), dev, args.trace)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

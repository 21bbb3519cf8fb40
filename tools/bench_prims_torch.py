#!/usr/bin/env python3
"""Microbenchmarks of the primitive ops the port's pipeline is built from.

The counterpart of tools/bench_prims.py (which times the JAX package) for
bfqzip_tpu_torch, on the same inputs (seed 0, n = 256 * 81920 by default):

  cumsum 1D i32 [n]                       torch.cumsum, int32 out
  cummax 1D i32 [n]                       torch.cummax (values and indices)
  cumsum [n,27] i32 axis0 + end-gather    the one-hot counts' prefix at cend
                                          (the JAX tool's layout; one timed
                                          call: on the card torch scans an
                                          outer axis this narrow slowly)
  cumsum [27,n] i32 last axis + end-gather  the same counts channel-first,
                                          the port's scan layout
  blocked sums+MXU prefix + end-gather    per-block sums, their exclusive
                                          prefix, and the in-block prefix as
                                          one bf16 product with a lower-
                                          triangular [256, 256] matrix
  blocked sums only (no in-block prefix)
  gather word[cid] (sorted) [n]
  gather rows X[cend] [ncap,27]           the one-hot rows built and gathered
  scatter set [n]->[ncap]                 cid repeats: the winner is not
                                          determined, so it is timed only
  scatter-add rows [nb*64,27]->[ncap,27]  index_add_
  sort 2-op / 4-op / 13-op [n]            1 / 2 / 11 keys with 1 / 2 / 2
                                          payloads: ops/suffix.py::_sort_lsd
                                          (one stable torch.sort pass per
                                          key) and a gather per payload
                                          through its permutation
  expand word[cid] via one-hot MXU        word[cid] from each 256-block's 64
                                          words by two f32 one-hot products

Each is the best of --reps calls after a warm-up (utils/profiling.best_ms:
CUDA events on the card), the [n, 27] cumsum the best of one.  The JAX
tool's bf16 product asks for f32 results; torch's gives bf16, which holds
every prefix count (<= 256) exactly: `checks.blocked_equal_cumsum` holds
the blocked result against the channel-first cumsum's.  The
expansion reads only the first 64 words of a block, so it is word[cid]
where a block spans fewer than 64 cids and 0 elsewhere:
`checks.expand_equal_gather` holds it against that.

    python3 tools/bench_prims_torch.py [--n N] [--reps 5] [--cpu]

Prints one JSON line: each label's ms, the checks, the device with its
power limit.  Without --cpu it needs a card.  Imports nothing of jax or
bfqzip_tpu.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bfqzip_tpu_torch.engine import resolve_device  # noqa: E402
from bfqzip_tpu_torch.ops.suffix import _sort_lsd  # noqa: E402
from bfqzip_tpu_torch.utils.profiling import best_ms, device_info  # noqa: E402

B = 256  # positions per block
C = 27  # one-hot channels
KL = 64  # words per block that the one-hot expansion reads
# timed calls of a label whose one call takes seconds on the card
SLOW = {"cumsum [n,27] i32 axis0 + end-gather": 1}


def inputs(n: int, device) -> dict:
    """The JAX tool's inputs, drawn in its order from seed 0."""
    if n % B:
        raise ValueError(f"n must be a multiple of {B}, got {n}")
    nb, ncap = n // B, n // 5 + 2
    rng = np.random.default_rng(0)
    x32 = rng.integers(0, 1 << 20, n).astype(np.int32)
    x8 = rng.integers(0, 6, n).astype(np.uint8)
    cid = np.minimum(np.sort(rng.integers(0, ncap, n)), ncap - 1).astype(np.int32)
    word = rng.integers(0, 1 << 30, ncap).astype(np.int32)
    cend = np.sort(rng.choice(n, ncap, replace=False)).astype(np.int32)
    rows_at = np.sort(rng.integers(0, ncap, nb * 64)).astype(np.int32)
    t = {k: torch.as_tensor(v).to(device) for k, v in
         (("x32", x32), ("x8", x8), ("cid", cid), ("word", word), ("cend", cend), ("rows_at", rows_at))}
    t["cid64"], t["cend64"] = t["cid"].long(), t["cend"].long()
    return t


def one_hot(a: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """[n, 27] int32 whose column c is (a == c); dim=0: channel-first [27, n]."""
    return torch.stack([(a == c).to(torch.int32) for c in range(C)], dim=dim)


def big_cumsum(a: torch.Tensor, cend: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(one_hot(a), 0, dtype=torch.int32)[cend]


def big_cumsum_cf(a: torch.Tensor, cend: torch.Tensor) -> torch.Tensor:
    """big_cumsum from the channel-first [27, n] counts, scanned along
    their last axis; [ncap, 27] like big_cumsum."""
    return torch.cumsum(one_hot(a, dim=0), 1, dtype=torch.int32)[:, cend].T


def blocked(a: torch.Tensor, cend: torch.Tensor) -> torch.Tensor:
    """big_cumsum by blocks: the exclusive prefix of per-block sums plus the
    in-block inclusive prefix, a bf16 product with a lower-triangular matrix."""
    n = a.shape[0]
    xb = one_hot(a).reshape(n // B, B, C)
    bs = xb.sum(dim=1, dtype=torch.int32)
    bp = torch.cumsum(bs, 0, dtype=torch.int32) - bs
    tril = torch.tril(torch.ones(B, B, dtype=torch.bfloat16, device=a.device))
    pb = torch.matmul(tril, xb.to(torch.bfloat16)).to(torch.int32)  # [nb, B, C]
    return bp[torch.div(cend, B, rounding_mode="floor")] + pb.reshape(n, C)[cend]


def blocked_sums(a: torch.Tensor) -> torch.Tensor:
    n = a.shape[0]
    return torch.cumsum(one_hot(a).reshape(n // B, B, C).sum(dim=1, dtype=torch.int32), 0,
                        dtype=torch.int32)


def expand_mm(w: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """word[cid] from each block's KL words starting at its first cid, as
    two exact f32 one-hot products (15 low and 15 high bits)."""
    n, ncap = c.shape[0], w.shape[0]
    cb = c.reshape(n // B, B)
    c0 = cb[:, 0]
    rows = c0[:, None] + torch.arange(KL, dtype=torch.int32, device=c.device)[None, :]
    ws = w[torch.clamp_max(rows, ncap - 1).long()]  # [nb, KL]
    local = cb - c0[:, None]  # [nb, B]
    oh = (local[:, :, None] == torch.arange(KL, dtype=torch.int32, device=c.device)).to(torch.float32)
    lo = torch.bmm(oh, (ws & 0x7FFF).to(torch.float32)[..., None])[..., 0].to(torch.int32)
    hi = torch.bmm(oh, (ws >> 15).to(torch.float32)[..., None])[..., 0].to(torch.int32)
    return (lo | (hi << 15)).reshape(n)


def expand_reference(w: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """What expand_mm computes: word[cid] where the cid lies within KL of its
    block's first, else 0."""
    cb = c.reshape(-1, B)
    inside = (cb - cb[:, :1] < KL).reshape(-1)
    return torch.where(inside, w[c.long()], torch.zeros((), dtype=w.dtype, device=w.device))


def sort_keys_payloads(keys: list, payloads: list) -> tuple:
    """A multi-key stable sort with payloads: _sort_lsd's passes, then one
    gather per payload through its permutation."""
    sa, skeys = _sort_lsd(keys)
    return sa, skeys, [p[sa] for p in payloads]


def run(n: int, device, reps: int = 5) -> dict:
    dev = resolve_device(device)
    t = inputs(n, dev)
    nb, ncap = n // B, n // 5 + 2
    x32, x8, word, cid, cend = t["x32"], t["x8"], t["word"], t["cid64"], t["cend64"]
    ones_rows = torch.ones(nb * 64, C, dtype=torch.int32, device=dev)
    arange_n = torch.arange(n, dtype=torch.int32, device=dev)

    def scatter_set():
        out = torch.zeros(ncap, dtype=torch.int32, device=dev)
        out[cid] = arange_n
        return out

    def scatter_add():
        return torch.zeros(ncap, C, dtype=torch.int32, device=dev).index_add_(0, t["rows_at"], ones_rows)

    cases = {
        "cumsum 1D i32 [n]": lambda: torch.cumsum(x32, 0, dtype=torch.int32),
        "cummax 1D i32 [n]": lambda: torch.cummax(x32, 0),
        "cumsum [n,27] i32 axis0 + end-gather": lambda: big_cumsum(x8, cend),
        "cumsum [27,n] i32 last axis + end-gather": lambda: big_cumsum_cf(x8, cend),
        "blocked sums+MXU prefix + end-gather": lambda: blocked(x8, cend),
        "blocked sums only (no in-block prefix)": lambda: blocked_sums(x8),
        "gather word[cid] (sorted) [n]": lambda: word[cid],
        "gather rows X[cend] [ncap,27]": lambda: one_hot(x8)[cend],
        "scatter set [n]->[ncap]": scatter_set,
        "scatter-add rows [nb*64,27]->[ncap,27]": scatter_add,
        "sort 2-op [n]": lambda: sort_keys_payloads([x32], [x32]),
        "sort 4-op [n]": lambda: sort_keys_payloads([x32, x32], [x32, x32]),
        "sort 13-op [n]": lambda: sort_keys_payloads([x32] * 11, [x32, x32]),
        "expand word[cid] via one-hot MXU": lambda: expand_mm(word, t["cid"]),
    }
    ms = {label: best_ms(fn, dev, SLOW.get(label, reps)) for label, fn in cases.items()}
    checks = {
        "blocked_equal_cumsum": bool(torch.equal(blocked(x8, cend), big_cumsum_cf(x8, cend))),
        "expand_equal_gather": bool(torch.equal(expand_mm(word, t["cid"]), expand_reference(word, t["cid"]))),
    }
    return {"device": device_info(dev), "n": n, "reps": reps, "ms": ms, "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=256 * 81920)  # ~21M
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.n, "cpu" if args.cpu else "cuda", args.reps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

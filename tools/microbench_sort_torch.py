#!/usr/bin/env python3
"""The suffix sort's cost model on the port: fixed and marginal cost per key
word and per payload, random gathers, batched sorts and a scatter.

The counterpart of tools/microbench_sort.py (which times jax.lax.sort) for
bfqzip_tpu_torch.  Torch has no multi-operand sort: a k-key sort is k
stable torch.sort passes, least significant key first, with the keys
gathered through the permutation between passes, which is the build's own
ops/suffix.py::_sort_lsd; its permutation is the index payload.  Every key
is int64 (the build's key words are int64; torch.sort on CUDA is not
relied on for unsigned types):

  sort u32 keys=k +idx stable     _sort_lsd over k words below 6^12 (the JAX
                                  tool's uint32 words), k in 1, 2, 3, 5, 9
  sort u32 keys=k +idx UNstable   the same passes with stable=False, k in 3,
                                  9; `unstable_identical` says whether the
                                  permutation and keys equal the stable ones
                                  (an unstable pass may keep ties in order)
  sort u64 keys=k +idx stable     k in 3, 5 words of 24 base-6 digits, two
                                  12-digit words each (suffix.PACK6 = 24)
  random gather n x i64 / n x i32 a word / an int32 index through a
                                  random permutation
  cumsum n                        torch.cumsum of (word & 1), int32
  batched sort [b,n/b] 9 keys     9 stable torch.sort(dim=1) passes with
                                  torch.gather, b in 36, 216
  scatter n x i32                 out[perm] = idx
  sort u32 keys=9 no payload      _sort_lsd over 9 words
  sort u32 keys=9 +3 payloads     the same plus 3 gathers through its
                                  permutation

Each is the best of --reps calls after a warm-up (utils/profiling.best_ms:
CUDA events on the card).  `model` derives the cost of a key word,
(keys=9 - keys=1) / 8, and of a payload, (+3 payloads - no payload) / 3.

    python3 tools/microbench_sort_torch.py [--n 20400000] [--reps 3] [--cpu]

Prints one JSON line naming the device with its power limit.  Without
--cpu it needs a card.  Imports nothing of jax or bfqzip_tpu.
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
from bfqzip_tpu_torch.ops.suffix import PACK6, _sort_lsd  # noqa: E402
from bfqzip_tpu_torch.utils.profiling import best_ms, device_info  # noqa: E402

HALF = 6 ** (PACK6 // 2)  # a 12-digit word's range
STABLE_KEYS = (1, 2, 3, 5, 9)
UNSTABLE_KEYS = (3, 9)
PACKED_KEYS = (3, 5)
BATCHES = (36, 216)


def batched_sort_lsd(mats: list) -> tuple:
    """Each row of [b, m] keys sorted on its own by the keys in order (mats[0]
    most significant), ties in position order: one stable torch.sort(dim=1)
    pass per key, least significant first.  (idx, sorted keys)."""
    b, m = mats[0].shape
    idx = torch.arange(m, dtype=torch.int64, device=mats[0].device).expand(b, m)
    for w in range(len(mats) - 1, -1, -1):
        key = mats[w] if w == len(mats) - 1 else mats[w].gather(1, idx)
        sorted_key, order = torch.sort(key, dim=1, stable=True)
        idx = idx.gather(1, order)
    return idx, [sorted_key] + [mats[w].gather(1, idx) for w in range(1, len(mats))]


def _same(a: tuple, b: tuple) -> bool:
    return torch.equal(a[0], b[0]) and all(torch.equal(x, y) for x, y in zip(a[1], b[1]))


def run(n: int, device, reps: int = 3) -> dict:
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    # the JAX tool's uint32 draws, held as int64
    words = [torch.as_tensor(rng.integers(0, HALF, n, dtype=np.uint32).astype(np.int64)).to(dev)
             for _ in range(12)]
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    ms, identical = {}, {}

    for k in STABLE_KEYS:
        ms[f"sort u32 keys={k} +idx stable"] = best_ms(lambda: _sort_lsd(words[:k]), dev, reps)
    for k in UNSTABLE_KEYS:
        ms[f"sort u32 keys={k} +idx UNstable"] = best_ms(lambda: _sort_lsd(words[:k], stable=False), dev, reps)
        identical[f"keys={k}"] = _same(_sort_lsd(words[:k]), _sort_lsd(words[:k], stable=False))

    packed = [words[2 * i] * HALF + words[2 * i + 1] for i in range(5)]
    for k in PACKED_KEYS:
        ms[f"sort u64 keys={k} +idx stable"] = best_ms(lambda: _sort_lsd(packed[:k]), dev, reps)
    del packed

    perm = torch.as_tensor(rng.permutation(n)).to(dev)
    ms["random gather n x i64"] = best_ms(lambda: words[0][perm], dev, reps)
    ms["random gather n x i32"] = best_ms(lambda: idx[perm], dev, reps)
    ms["cumsum n"] = best_ms(lambda: torch.cumsum((words[0] & 1).to(torch.int32), 0, dtype=torch.int32),
                             dev, reps)

    for b in BATCHES:
        m = n // b
        mats = [w[: b * m].reshape(b, m) for w in words[:9]]
        ms[f"batched sort [{b},{m}] 9 keys"] = best_ms(lambda: batched_sort_lsd(mats), dev, reps)

    def scatter():
        out = torch.zeros_like(idx)
        out[perm] = idx
        return out

    ms["scatter n x i32"] = best_ms(scatter, dev, reps)

    def with_payloads():
        sa, skeys = _sort_lsd(words[:9])
        return sa, skeys, [p[sa] for p in (idx, words[9], words[10])]

    ms["sort u32 keys=9 no payload"] = best_ms(lambda: _sort_lsd(words[:9]), dev, reps)
    ms["sort u32 keys=9 +3 payloads"] = best_ms(with_payloads, dev, reps)
    model = {
        "per_key_word_ms": (ms["sort u32 keys=9 +idx stable"] - ms["sort u32 keys=1 +idx stable"]) / 8,
        "per_payload_ms": (ms["sort u32 keys=9 +3 payloads"] - ms["sort u32 keys=9 no payload"]) / 3,
    }
    return {"device": device_info(dev), "n": n, "reps": reps, "ms": ms, "model": model,
            "unstable_identical": identical}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=20_400_000)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.n, "cpu" if args.cpu else "cuda", args.reps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Segmented-scan candidates for the smoother, each through the port's CUDA
kernel and through its plain PyTorch version.

The counterpart of tools/bench_prims2.py (which times the JAX package's
associative scans) for bfqzip_tpu_torch, on the same inputs (seed 0,
n = 256 * 81920 by default, 1% reset flags):

  seg-sum ([n] i32, flag)        op add on [n] int32
  seg-sum ([5,n] i32, flag)      op add on [5, n] channel-first int32 (one
                                 flag row for every channel)
  seg-or ([n] i32, flag)         op or
  last-marked ([n] i32, flag)    op keepleft: the value at the latest flag
  two-level(B=8) seg-sum [n] i32 an 8-step in-block scan in torch, then a
                                 segmented add over the block tails

Each candidate runs through ops/cuda_scan.seg_scan (csrc/seg_scan.cu, the
port of the JAX package's Pallas scan) and through ops/scan.seg_scan, the
plain version, on the same inputs: `kernel_ms` and `plain_ms` are each the
best of --reps calls after a warm-up (utils/profiling.best_ms: CUDA events
on the card), `equal` says the two outputs are equal.  The two-level
scheme's block-tail scan is the kernel in its kernel run and the plain
version in its plain run; both are held against the plain one-level
seg-sum.  `sort 7-op honest [n]` is five distinct int32 keys with two
payloads: ops/suffix.py::_sort_lsd and two gathers through its permutation.
`seg_scan_launches` counts the kernel's launches in the whole run.  With
--cpu only the plain versions run (the kernel needs CUDA tensors): the
kernel's fields are null.

    python3 tools/bench_prims2_torch.py [--n N] [--reps 5] [--cpu]

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
from bfqzip_tpu_torch.ops import cuda_scan, scan  # noqa: E402
from bfqzip_tpu_torch.ops.suffix import _sort_lsd  # noqa: E402
from bfqzip_tpu_torch.utils.profiling import best_ms, device_info  # noqa: E402

TWO_LEVEL_B = 8
# label -> (input, op)
CANDIDATES = {
    "seg-sum ([n] i32, flag)": ("x", "add"),
    "seg-sum ([5,n] i32, flag)": ("x5", "add"),
    "seg-or ([n] i32, flag)": ("x", "or"),
    "last-marked ([n] i32, flag)": ("x", "keepleft"),
}
TWO_LEVEL = "two-level(B=8) seg-sum [n] i32"
SORT = "sort 7-op honest [n]"


def inputs(n: int, device) -> dict:
    """The JAX tool's inputs, drawn in its order from seed 0 ([n, 5] drawn
    as the JAX tool draws it, stored channel-first)."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 100, n).astype(np.int32)
    x5 = np.ascontiguousarray(rng.integers(0, 100, (n, 5)).astype(np.int32).T)
    reset = rng.random(n) < 0.01
    sort_ops = [rng.integers(0, 1 << 30, n).astype(np.int32) for _ in range(7)]
    return {"x": torch.as_tensor(x).to(device), "x5": torch.as_tensor(x5).to(device),
            "reset": torch.as_tensor(reset).to(device),
            "sort_ops": [torch.as_tensor(o).to(device) for o in sort_ops]}


def two_level(x: torch.Tensor, reset: torch.Tensor, seg_scan, B: int = TWO_LEVEL_B) -> torch.Tensor:
    """Segmented sum in two levels: B in-block steps over [B, n/B], then
    `seg_scan` (the kernel or the plain version) over the block tails, whose
    exclusive prefix is added where no flag precedes a slot in its block."""
    n = x.shape[0]
    if n % B:
        raise ValueError(f"n must be a multiple of {B}, got {n}")
    xb = x.reshape(n // B, B).T
    rb = reset.reshape(n // B, B).T
    vs = torch.empty_like(xb)
    seen = torch.empty_like(rb)
    carry = torch.zeros(n // B, dtype=x.dtype, device=x.device)
    any_flag = torch.zeros(n // B, dtype=torch.bool, device=x.device)
    for i in range(B):
        carry = torch.where(rb[i], xb[i], carry + xb[i])
        any_flag = any_flag | rb[i]
        vs[i], seen[i] = carry, any_flag
    tails = seg_scan(vs[-1].contiguous(), seen[-1].contiguous(), "add", 0)
    pexcl = torch.cat([torch.zeros(1, dtype=x.dtype, device=x.device), tails[:-1]])
    return torch.where(seen, vs, vs + pexcl[None, :]).T.reshape(-1)


def run(n: int, device, reps: int = 5) -> dict:
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    t = inputs(n, dev)
    reset = t["reset"]
    launches0 = cuda_scan.launches
    res = {}
    for label, (name, op) in CANDIDATES.items():
        x = t[name]
        plain = scan.seg_scan(x, reset, op, 0)
        row = {"op": op, "shape": list(x.shape),
               "plain_ms": best_ms(lambda: scan.seg_scan(x, reset, op, 0), dev, reps),
               "kernel_ms": None, "equal": None}
        if on_card:
            row["equal"] = bool(torch.equal(cuda_scan.seg_scan(x, reset, op, 0), plain))
            row["kernel_ms"] = best_ms(lambda: cuda_scan.seg_scan(x, reset, op, 0), dev, reps)
        res[label] = row

    x = t["x"]
    one_level = scan.seg_scan(x, reset, "add", 0)
    row = {"op": "add", "shape": [n], "block": TWO_LEVEL_B,
           "plain_ms": best_ms(lambda: two_level(x, reset, scan.seg_scan), dev, reps),
           "plain_equal": bool(torch.equal(two_level(x, reset, scan.seg_scan), one_level)),
           "kernel_ms": None, "equal": None}
    if on_card:
        row["equal"] = bool(torch.equal(two_level(x, reset, cuda_scan.seg_scan), one_level))
        row["kernel_ms"] = best_ms(lambda: two_level(x, reset, cuda_scan.seg_scan), dev, reps)
    res[TWO_LEVEL] = row

    keys, payloads = t["sort_ops"][:5], t["sort_ops"][5:]

    def sort7():
        sa, skeys = _sort_lsd(keys)
        return sa, skeys, [p[sa] for p in payloads]

    return {"device": device_info(dev), "n": n, "reps": reps, "flag_share": float(reset.float().mean()),
            "candidates": res, SORT: {"ms": best_ms(sort7, dev, reps), "keys": 5, "payloads": 2},
            "seg_scan_launches": cuda_scan.launches - launches0}


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

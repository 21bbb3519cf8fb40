"""Distributed scan/shift toolbox: ops.scan.LocalScanOps over a process group.

Port of bfqzip_tpu/parallel/dist_scan.py.  Each operation is the local op
(ops/scan.py LOCAL_OPS: the CUDA kernel on CUDA tensors) plus ONE
collective carry step, so the sequence-sharded smoothing of
parallel/global_pipeline.py runs the single-device cluster maths of
ops/smooth.py unchanged:

  * shifts exchange a k-element halo with the neighbouring rank;
  * cummax / segmented scans all_gather one per-rank summary (d tails, or
    [d, C]) and fold the carry on the device with a loop over the ranks
    before this one;
  * next_marked (the right-to-left keep-left scan) carries from the RIGHT:
    the first marked rank after this one supplies its tail;
  * sums are all-reduced.

The carry is applied as where(seen, local, combine(carry, local)), as the
JAX package does, never by rescanning with the carry as the kernel's init:
for float64 add, carry + local rounds differently from a scan seeded with
the carry, and mode 1 rounds those sums against thresholds.

Ranks must hold CONTIGUOUS equal-length slices of the global array (the
exact-rebalanced sorted order of global_ebwt.Ctx.rebalance).
"""

from __future__ import annotations

import torch

from bfqzip_tpu_torch.ops.scan import _COMBINE, LOCAL_OPS
from bfqzip_tpu_torch.parallel.comm import Comm


class DistScanOps:
    """LocalScanOps interface over a Comm; every method takes this rank's
    [m]-shaped (or [C, m]) local slice."""

    def __init__(self, comm: Comm):
        self.comm = comm
        self.d = comm.d

    def _me(self) -> int:
        return self.comm.shard_id()

    def iota(self, m: int, device) -> torch.Tensor:
        return self._me() * m + torch.arange(m, dtype=torch.int32, device=device)

    def shift_prev(self, x, fill):
        last = self.comm.from_prev(x[-1:])
        if self._me() == 0:
            last = torch.full((1,), fill, dtype=x.dtype, device=x.device)
        return torch.cat([last, x[:-1]])

    def shift_next(self, x, fill):
        return self.shift_next_k(x, 1, fill)

    def shift_next_k(self, x, k: int, fill):
        head = self.comm.from_next(x[:k])
        if self._me() == self.d - 1:
            head = torch.full((k,), fill, dtype=x.dtype, device=x.device)
        return torch.cat([x[k:], head])

    def cummax(self, x):
        local = LOCAL_OPS.cummax(x)
        totals = self.comm.all_gather(local[-1])  # [d]
        me = self._me()
        if me == 0:
            return local
        return torch.maximum(local, totals[:me].max())

    def seg_scan(self, x, flag, op: str, init):
        combine = _COMBINE[op]
        local = LOCAL_OPS.seg_scan(x, flag, op, init)
        tails = self.comm.all_gather(local[..., -1])  # [d] or [d, C]
        anyfs = self.comm.all_gather(flag.any())  # [d]
        carry = torch.full(tails.shape[1:], init, dtype=x.dtype, device=x.device)
        for t in range(self._me()):
            carry = torch.where(anyfs[t], tails[t], combine(carry, tails[t]))
        # positions at or after this rank's first flag are unaffected
        seen = torch.cumsum(flag.to(torch.int32), 0) > 0
        carried = combine(carry[:, None] if x.dim() == 2 else carry, local)
        return torch.where(seen, local, carried)

    def seg_cumsum(self, x, reset):
        return self.seg_scan(x, reset, "add", 0)

    def seg_cummax(self, x, reset):
        """Segmented max for non-negative x (0 before the first reset)."""
        return self.seg_scan(x, reset, "max", 0)

    def seg_cumor(self, x, reset):
        return self.seg_scan(x, reset, "or", 0)

    def next_marked(self, x, mark, init=0):
        local = LOCAL_OPS.next_marked(x, mark, init)
        firsts = self.comm.all_gather(local[0])  # value at my first mark, valid iff any
        anyms = self.comm.all_gather(mark.any())  # [d]
        carry = torch.full((), init, dtype=x.dtype, device=x.device)
        for t in range(self.d - 1, self._me(), -1):  # nearest marked rank after mine
            carry = torch.where(anyms[t], firsts[t], carry)
        # positions with a local mark at or after them keep the local value
        seen_right = torch.cumsum(mark.flip(0).to(torch.int32), 0).flip(0) > 0
        return torch.where(seen_right, local, carry)

    def sum(self, x):
        return self.comm.psum(torch.sum(x))

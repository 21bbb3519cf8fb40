"""Collectives of one process group: the port's counterpart of jax.shard_map
and the jax.lax collectives that the JAX package's parallel bodies use.

A rank is one process, and one device (bfqzip_tpu/parallel/ runs one shard
per device inside one jitted program; here every rank runs the same Python
body, and the collectives meet in torch.distributed):

    jax.lax.axis_index            Comm.shard_id
    jax.lax.all_to_all(tiled)     Comm.a2a          (all_to_all_single)
    jax.lax.all_gather            Comm.all_gather   ([d, ...])
    jax.lax.psum                  Comm.psum         (all_reduce)
    jax.lax.ppermute, cyclic      Comm.from_prev_cyclic / from_next_cyclic
    jax.lax.ppermute, open ends   Comm.from_prev / from_next (zero fill)

The backend is the group's: NCCL for CUDA tensors, one rank per card; gloo
for the CPU.  Gloo runs most collectives on host tensors only, so for a gloo
group whose ranks hold CUDA tensors (several ranks sharing one card) each
collective copies its operand to the host and its result back, and counts
those bytes in `staged_bytes`.  That follows from the group's backend, which
the caller chose; it is never a reaction to an error.

Boolean tensors travel as uint8.  `sent_bytes` counts the bytes this rank
hands to collectives.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class Comm:
    """One rank's view of a process group: rank, world size d, device."""

    def __init__(self, device, group=None):
        self.group = group if group is not None else dist.group.WORLD
        self.rank = dist.get_rank(self.group)
        self.d = dist.get_world_size(self.group)
        self.device = torch.device(device)
        self.backend = dist.get_backend(self.group)
        self.stage = self.backend == "gloo" and self.device.type == "cuda"
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError(f"an NCCL group needs CUDA tensors, this rank holds {self.device}")
        self.sent_bytes = 0
        self.staged_bytes = 0

    # -- wire helpers -----------------------------------------------------
    def _out(self, x: torch.Tensor):
        """(wire tensor, dtype to restore): bool as uint8, on the host for a
        staged group."""
        dtype = x.dtype
        if dtype == torch.bool:
            x = x.to(torch.uint8)
        x = x.contiguous()
        self.sent_bytes += x.numel() * x.element_size()
        if self.stage:
            x = x.cpu()
            self.staged_bytes += x.numel() * x.element_size()
        return x, dtype

    def _back(self, y: torch.Tensor, dtype) -> torch.Tensor:
        if self.stage:
            self.staged_bytes += y.numel() * y.element_size()
            y = y.to(self.device)
        return y.to(dtype) if dtype == torch.bool else y

    # -- collectives --------------------------------------------------------
    def shard_id(self) -> int:
        return self.rank

    def a2a(self, x: torch.Tensor) -> torch.Tensor:
        """[d, cap, ...] -> [d, cap, ...]: block s goes to rank s, and block s
        of the result came from rank s (the tiled all_to_all)."""
        if x.shape[0] != self.d:
            raise ValueError(f"a2a needs a leading axis of {self.d}, got {tuple(x.shape)}")
        w, dtype = self._out(x)
        y = torch.empty_like(w)
        dist.all_to_all_single(y, w, group=self.group)
        return self._back(y, dtype)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[...] -> [d, ...], rank order."""
        w, dtype = self._out(x)
        parts = [torch.empty_like(w) for _ in range(self.d)]
        dist.all_gather(parts, w, group=self.group)
        return self._back(torch.stack(parts), dtype)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        w, dtype = self._out(x)
        w = w.clone()
        dist.all_reduce(w, op=dist.ReduceOp.SUM, group=self.group)
        return self._back(w, dtype)

    def _permute(self, x: torch.Tensor, src: int | None, dst: int | None) -> torch.Tensor:
        """Send x to rank dst and receive from rank src (None: no partner;
        the result is then zeros)."""
        w, dtype = self._out(x)
        y = torch.zeros_like(w)
        ops = []
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, w, dist.get_global_rank(self.group, dst), self.group))
        if src is not None:
            ops.append(dist.P2POp(dist.irecv, y, dist.get_global_rank(self.group, src), self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return self._back(y, dtype)

    def from_prev_cyclic(self, x: torch.Tensor) -> torch.Tensor:
        """x of rank (me - 1) mod d."""
        if self.d == 1:
            return x.clone()
        return self._permute(x, (self.rank - 1) % self.d, (self.rank + 1) % self.d)

    def from_next_cyclic(self, x: torch.Tensor) -> torch.Tensor:
        """x of rank (me + 1) mod d."""
        if self.d == 1:
            return x.clone()
        return self._permute(x, (self.rank + 1) % self.d, (self.rank - 1) % self.d)

    def from_prev(self, x: torch.Tensor) -> torch.Tensor:
        """x of rank me - 1; zeros on rank 0."""
        src = self.rank - 1 if self.rank > 0 else None
        dst = self.rank + 1 if self.rank < self.d - 1 else None
        return self._permute(x, src, dst)

    def from_next(self, x: torch.Tensor) -> torch.Tensor:
        """x of rank me + 1; zeros on the last rank."""
        src = self.rank + 1 if self.rank < self.d - 1 else None
        dst = self.rank - 1 if self.rank > 0 else None
        return self._permute(x, src, dst)

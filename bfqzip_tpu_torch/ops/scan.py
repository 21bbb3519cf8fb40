"""Segmented scans and the scan/shift toolbox of the smoother.

Semantics (as bfqzip_tpu/ops/scan.py):

    out[i] = x[i]                    if flag[i]
             combine(out[i-1], x[i]) otherwise,   out[-1] = init

i.e. `flag` RESTARTS the scan at i.  `x` is [n] or channel-first [C, n];
one flag row serves every channel.  `op` names combine: "add", "max", "or"
or "keepleft" (combine(a, b) = a, so a keep-left scan repeats the value at
the most recent flag, and gives init before the first).

`seg_scan` below is the plain PyTorch version: a Hillis-Steele segmented
network, exact for integers.  `LocalScanOps` sends every scan on a CUDA
tensor through the hand-written kernel (ops/cuda_scan.py) and uses the plain
version only for tensors on the CPU.
"""

from __future__ import annotations

import torch

from bfqzip_tpu_torch.ops import cuda_scan

INT32_MIN = -(2**31)

_COMBINE = {
    "add": torch.add,
    "max": torch.maximum,
    "or": torch.bitwise_or,
    "keepleft": lambda a, b: a.expand_as(b),
}


def seg_scan(x: torch.Tensor, flag: torch.Tensor, op: str, init) -> torch.Tensor:
    """Plain PyTorch inclusive segmented scan (see module docstring)."""
    combine = _COMBINE[op]
    v = x
    f = flag.to(torch.bool)
    n = x.shape[-1]
    d = 1
    while d < n:
        # (v1, f1) o (v2, f2) = (f2 ? v2 : combine(v1, v2), f1 | f2)
        tail = torch.where(f[d:], v[..., d:], combine(v[..., :-d], v[..., d:]))
        v = torch.cat([v[..., :d], tail], dim=-1)
        f = torch.cat([f[:d], f[d:] | f[:-d]])
        d <<= 1
    # positions with no flag at or before them continue from init
    init_t = torch.full((), init, dtype=x.dtype, device=x.device)
    return torch.where(f, v, combine(init_t, v))


class LocalScanOps:
    """Single-device scan/shift toolbox used by ops.smooth.

    Same interface as bfqzip_tpu.ops.scan.LocalScanOps, except that iota
    takes the device and seg_scan names its combine by string.  Every scan
    goes through `_scan`: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors.
    """

    def iota(self, n: int, device) -> torch.Tensor:
        """Global position of each local slot."""
        return torch.arange(n, dtype=torch.int32, device=device)

    def shift_prev(self, x: torch.Tensor, fill) -> torch.Tensor:
        """out[i] = x[i-1]; out[0] = fill."""
        return torch.cat([torch.full((1,), fill, dtype=x.dtype, device=x.device), x[:-1]])

    def shift_next(self, x: torch.Tensor, fill) -> torch.Tensor:
        """out[i] = x[i+1]; out[-1] = fill."""
        return torch.cat([x[1:], torch.full((1,), fill, dtype=x.dtype, device=x.device)])

    def shift_next_k(self, x: torch.Tensor, k: int, fill) -> torch.Tensor:
        """out[i] = x[i+k]; the last k slots get fill."""
        return torch.cat([x[k:], torch.full((k,), fill, dtype=x.dtype, device=x.device)])

    def _scan(self, x, flag, op: str, init, reverse: bool = False) -> torch.Tensor:
        if x.is_cuda:
            return cuda_scan.seg_scan(x.contiguous(), flag.contiguous(), op, init, reverse)
        if x.device.type != "cpu":
            raise ValueError(f"no segmented scan for device {x.device}")
        if reverse:
            return seg_scan(x.flip(-1), flag.flip(0), op, init).flip(-1)
        return seg_scan(x, flag, op, init)

    def cummax(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[-1]
        return self._scan(x, torch.zeros(n, dtype=torch.bool, device=x.device), "max", INT32_MIN)

    def seg_scan(self, x: torch.Tensor, flag: torch.Tensor, op: str, init) -> torch.Tensor:
        return self._scan(x, flag, op, init)

    def seg_cumsum(self, x: torch.Tensor, reset: torch.Tensor) -> torch.Tensor:
        return self._scan(x, reset, "add", 0)

    def seg_cummax(self, x: torch.Tensor, reset: torch.Tensor) -> torch.Tensor:
        """Segmented max for non-negative x (0 before the first reset)."""
        return torch.clamp_min(self._scan(x, reset, "max", INT32_MIN), 0)

    def seg_cumor(self, x: torch.Tensor, reset: torch.Tensor) -> torch.Tensor:
        return self._scan(x, reset, "or", 0)

    def next_marked(self, x: torch.Tensor, mark: torch.Tensor, init=0) -> torch.Tensor:
        """out[i] = x at the nearest mark >= i (init after the last mark)."""
        return self._scan(x, mark, "keepleft", init, reverse=True)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sum(x)


LOCAL_OPS = LocalScanOps()

"""Rank / LF mapping in PyTorch.

Port of bfqzip_tpu/ops/rank.py.  LF[i] = C[bwt[i]] + rank_{bwt[i]}(i): the
five per-symbol inclusive counts are ONE [5, n_pad] int32 scan with an
all-false flag row, so on a CUDA tensor they are one launch of the seg_scan
kernel and on the CPU the plain scan.
"""

from __future__ import annotations

import torch

from bfqzip_tpu_torch import alphabet
from bfqzip_tpu_torch.ops.scan import LOCAL_OPS


def counts(bwt: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Symbol counts [SIGMA] over the valid positions."""
    return torch.stack([((bwt == c) & valid).sum(dtype=torch.int32) for c in range(alphabet.SIGMA)])


def lf_array(bwt: torch.Tensor, valid: torch.Tensor, ops=None) -> torch.Tensor:
    """LF[i] for every valid non-terminator position; TERM and padding
    positions keep LF[i] = i."""
    ops = ops or LOCAL_OPS
    n_pad = bwt.shape[0]
    dev = bwt.device
    codes = torch.arange(1, alphabet.SIGMA, dtype=torch.uint8, device=dev)[:, None]
    is_c = (bwt[None, :] == codes) & valid[None, :]  # [5, n_pad]
    occ = ops.seg_cumsum(is_c.to(torch.int32), torch.zeros(n_pad, dtype=torch.bool, device=dev))
    cnt = counts(bwt, valid)
    cbase = torch.cumsum(cnt, 0, dtype=torch.int32)[:-1]  # C[c] for c = 1..5
    lf = torch.arange(n_pad, dtype=torch.int32, device=dev)
    for c in range(alphabet.SIGMA - 1):
        lf = torch.where(is_c[c], cbase[c] + occ[c] - 1, lf)
    return lf

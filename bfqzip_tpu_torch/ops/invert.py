"""EBWT inversion through the suffix array, in PyTorch.

Port of bfqzip_tpu/ops/invert.py::invert_via_sa and illumina_bin_jax.  Each
non-terminator BWT position i holds the (possibly corrected) read character
at text slot SA[i]-1, and (SA-1) mod n_pad is a bijection over the text
slots, so the smoothed reads are ONE scatter of packed (quality, base) pairs
into the [N, L+1] grid.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bfqzip_tpu import alphabet

_BINS = ((2, 6), (10, 15), (20, 22), (25, 27), (30, 33), (35, 37), (40, 40))


class InvertOut(NamedTuple):
    seqs: torch.Tensor  # [N, L] u8 codes, zero-padded
    quals: torch.Tensor  # [N, L] u8 raw ASCII, zero-padded
    lengths: torch.Tensor  # [N] i32


def illumina_bin(qs: torch.Tensor) -> torch.Tensor:
    """Illumina 8-level binning on raw ASCII qualities."""
    q = qs.to(torch.int32) - 33
    out = q
    for lo, v in _BINS:
        out = torch.where(q >= lo, v, out)
    return (out + 33).to(torch.uint8)


def invert_via_sa(
    sa: torch.Tensor,
    bwt: torch.Tensor,
    bwt_sub: torch.Tensor,
    qs: torch.Tensor,
    n: torch.Tensor,
    n_reads: int,
    width: int,
    binning: bool = False,
) -> InvertOut:
    if binning:
        qs = illumina_bin(qs)
    n_pad = bwt.shape[0]
    wp = n_pad // n_reads  # width + 1
    idx = torch.arange(n_pad, dtype=torch.int32, device=bwt.device)
    is_char = (bwt != alphabet.TERM) & (bwt != alphabet.SIGMA) & (idx < n)
    target = torch.remainder(sa.to(torch.int64) - 1, n_pad)
    packed = torch.where(is_char, (qs.to(torch.int32) << 8) | bwt_sub.to(torch.int32), 0)
    grid = torch.empty(n_pad, dtype=torch.int32, device=bwt.device)
    grid[target] = packed  # every slot receives exactly one entry
    grid = grid.view(n_reads, wp)[:, :width]
    seqs = (grid & 0xFF).to(torch.uint8)
    quals = ((grid >> 8) & 0xFF).to(torch.uint8)
    lengths = (seqs != 0).sum(dim=1, dtype=torch.int32)
    return InvertOut(seqs=seqs, quals=quals, lengths=lengths)

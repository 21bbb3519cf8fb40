"""EBWT inversion in PyTorch: through the suffix array, or by the LF walk.

Port of bfqzip_tpu/ops/invert.py (invert_via_sa, invert, illumina_bin_jax).
Each non-terminator BWT position i holds the (possibly corrected) read
character at text slot SA[i]-1, and (SA-1) mod n_pad is a bijection over the
text slots, so with the suffix array the smoothed reads are ONE scatter of
packed (quality, base) pairs into the [N, L+1] grid.  Without it (the cached
artifacts, BQZE archives) `invert` walks LF from the terminators.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bfqzip_tpu_torch import alphabet

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


def invert(
    bwt: torch.Tensor,
    bwt_sub: torch.Tensor,
    qs: torch.Tensor,
    lf: torch.Tensor,
    n_reads: int,
    width: int,
    binning: bool = False,
) -> InvertOut:
    """Reconstruction by the lock-step backward LF walk, for EBWTs that carry
    no suffix array (the cached artifacts, BQZE archives).

    BWT positions 0..N-1 are the terminator suffixes in read order; all N
    reads advance one LF step per iteration, collecting substituted bases and
    qualities right to left, and each row is then reversed to read order.
    """
    if binning:
        qs = illumina_bin(qs)
    # payload word: [16:24]=quality  [8:16]=substituted base  [0]=not-TERM,
    # so each step makes two gathers: the payload and LF
    payload = (
        (qs.to(torch.int32) << 16)
        | (bwt_sub.to(torch.int32) << 8)
        | (bwt != alphabet.TERM).to(torch.int32)
    )
    pos = torch.arange(n_reads, dtype=torch.int32, device=bwt.device)
    bcols, qcols, act = [], [], []
    for _ in range(width):
        w = payload[pos]
        active = (w & 1) == 1
        bcols.append(torch.where(active, (w >> 8) & 0xFF, 0).to(torch.uint8))
        qcols.append(torch.where(active, (w >> 16) & 0xFF, 0).to(torch.uint8))
        act.append(active)
        pos = torch.where(active, lf[pos], pos)
    lengths = torch.stack(act).sum(dim=0, dtype=torch.int32)  # [N]

    # emitted column t holds read char at index len-1-t; reverse via gather
    t_idx = lengths[None, :] - 1 - torch.arange(width, dtype=torch.int32, device=bwt.device)[:, None]
    ok = t_idx >= 0
    t_clamped = t_idx.clamp_min(0).long()
    zero = torch.zeros((), dtype=torch.uint8, device=bwt.device)
    seqs = torch.where(ok, torch.stack(bcols).gather(0, t_clamped), zero).T.contiguous()
    quals = torch.where(ok, torch.stack(qcols).gather(0, t_clamped), zero).T.contiguous()
    return InvertOut(seqs=seqs, quals=quals, lengths=lengths)

"""Single-device end-to-end engine: FASTQ batch -> smoothed FASTQ batch.

Port of bfqzip_tpu/engine.py: smooth_step / smooth_fastq (build_ebwt ->
smooth -> invert_via_sa) and smooth_arrays_step (cached artifacts ->
lf_array -> smooth -> LF-walk invert), run eagerly on the device of the
input tensors.  No shape bucketing: PyTorch does not recompile per shape.
"""

from __future__ import annotations

from typing import Tuple

import torch

from bfqzip_tpu_torch import alphabet
from bfqzip_tpu_torch.config import SmoothConfig
from bfqzip_tpu_torch.io.fastq import ReadBatch
from bfqzip_tpu_torch.convert import batch_to_tensors
from bfqzip_tpu_torch.ops.invert import InvertOut, invert, invert_via_sa
from bfqzip_tpu_torch.ops.smooth import lf_and_pre, smooth
from bfqzip_tpu_torch.ops.suffix import EbwtDevice, build_ebwt
from bfqzip_tpu_torch.utils.profiling import resolve_device, span


def pre_of(ebwt: EbwtDevice) -> torch.Tensor:
    """The symbol preceding each BWT position, bwt[LF[i]], which is the text
    symbol at SA[i]-2: the flat build carries it through its sort; for the
    doubling build it is one gather through SA (an LF array would cost a
    [5, n_pad] scan)."""
    if ebwt.pre is not None:
        return ebwt.pre
    t = ebwt.text[torch.remainder(ebwt.sa.to(torch.int64) - 2, ebwt.text.shape[0])]
    return torch.where(t == 0, torch.full((), alphabet.TERM, dtype=torch.uint8, device=t.device), t - 1)


def smooth_step(
    seqs: torch.Tensor, quals: torch.Tensor, lengths: torch.Tensor, cfg: SmoothConfig
) -> Tuple[InvertOut, dict]:
    """The full device-side pipeline on a padded [N, L] read batch."""
    n_reads, width = seqs.shape
    ebwt = build_ebwt(seqs, quals, lengths)
    out = smooth(ebwt, cfg, pre=pre_of(ebwt))
    with span("invert.invert_via_sa"):
        inv = invert_via_sa(
            ebwt.sa, ebwt.bwt, out.bwt_sub, out.qs, ebwt.n, n_reads, width, binning=cfg.binning
        )
    return inv, out.stats


def smooth_arrays_step(
    bwt: torch.Tensor, qs: torch.Tensor, lcp: torch.Tensor, n: torch.Tensor,
    n_reads: int, width: int, cfg: SmoothConfig,
) -> Tuple[InvertOut, torch.Tensor, torch.Tensor, dict]:
    """Smooth + invert from step-1 artifacts (bwt/qs/lcp padded past `n`,
    n a 0-d int32 tensor on their device).  They carry no suffix array, so
    LF is computed once: pre = bwt[LF] for the smoother, and the LF walk
    inverts."""
    with span("engine.smooth_arrays_step"):
        with span("rank.lf_and_pre"):
            lf, pre = lf_and_pre(bwt, n)
        ebwt = EbwtDevice(bwt=bwt, qs=qs, lcp=lcp, sa=None, text=None, n=n)
        out = smooth(ebwt, cfg, pre=pre)
        with span("invert.invert"):
            inv = invert(bwt, out.bwt_sub, out.qs, lf, n_reads, width, binning=cfg.binning)
    return inv, out.bwt_sub, out.qs, out.stats


def smooth_fastq(
    batch: ReadBatch, cfg: SmoothConfig | None = None, device="cuda"
) -> Tuple[ReadBatch, dict]:
    """Host wrapper: numpy ReadBatch in, smoothed numpy ReadBatch out."""
    cfg = cfg or SmoothConfig()
    dev = resolve_device(device)
    with span("engine.smooth_fastq"):
        with span("engine.upload"):
            tensors = batch_to_tensors(batch, dev)
        inv, stats = smooth_step(*tensors, cfg)
        del tensors
        with span("engine.download"):
            out = ReadBatch(
                seqs=inv.seqs.cpu().numpy(),
                quals=inv.quals.cpu().numpy(),
                lengths=inv.lengths.cpu().numpy(),
                headers=batch.headers,
            )
        return out, {k: int(v) for k, v in stats.items()}

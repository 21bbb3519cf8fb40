"""Single-device end-to-end engine: FASTQ batch -> smoothed FASTQ batch.

Port of bfqzip_tpu/engine.py::smooth_step / smooth_fastq: build_ebwt ->
smooth -> invert_via_sa, run eagerly on the device of the input tensors.
No shape bucketing: PyTorch does not recompile per shape.
"""

from __future__ import annotations

from typing import Tuple

import torch

from bfqzip_tpu.config import SmoothConfig
from bfqzip_tpu.io.fastq import ReadBatch
from bfqzip_tpu_torch.convert import batch_to_tensors
from bfqzip_tpu_torch.ops.invert import InvertOut, invert_via_sa
from bfqzip_tpu_torch.ops.smooth import smooth
from bfqzip_tpu_torch.ops.suffix import build_ebwt


def smooth_step(
    seqs: torch.Tensor, quals: torch.Tensor, lengths: torch.Tensor, cfg: SmoothConfig
) -> Tuple[InvertOut, dict]:
    """The full device-side pipeline on a padded [N, L] read batch."""
    n_reads, width = seqs.shape
    ebwt = build_ebwt(seqs, quals, lengths)
    out = smooth(ebwt, cfg, pre=ebwt.pre)
    inv = invert_via_sa(
        ebwt.sa, ebwt.bwt, out.bwt_sub, out.qs, ebwt.n, n_reads, width, binning=cfg.binning
    )
    return inv, out.stats


def resolve_device(device) -> torch.device:
    """The device asked for; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False")
    return dev


def smooth_fastq(
    batch: ReadBatch, cfg: SmoothConfig | None = None, device="cuda"
) -> Tuple[ReadBatch, dict]:
    """Host wrapper: numpy ReadBatch in, smoothed numpy ReadBatch out."""
    cfg = cfg or SmoothConfig()
    dev = resolve_device(device)
    inv, stats = smooth_step(*batch_to_tensors(batch, dev), cfg)
    out = ReadBatch(
        seqs=inv.seqs.cpu().numpy(),
        quals=inv.quals.cpu().numpy(),
        lengths=inv.lengths.cpu().numpy(),
        headers=batch.headers,
    )
    return out, {k: int(v) for k, v in stats.items()}

"""Data-parallel block pipeline: one independent EBWT per rank.

Port of bfqzip_tpu/parallel/block.py, the reference's parallel mode
(split the FASTQ into equal read blocks, run the whole in-memory pipeline
per block, concatenate the outputs in block order).  Each rank runs its
block through the single-device engine (build -> smooth -> invert), the
stats are all-reduced, and the blocks come back in block order.  Blocks
are independent EBWTs, so the split carries the reference's
compression-ratio cost.
"""

from __future__ import annotations

import tempfile
from typing import Tuple

import numpy as np
import torch

from bfqzip_tpu_torch import alphabet
from bfqzip_tpu_torch.config import SmoothConfig
from bfqzip_tpu_torch.engine import smooth_step
from bfqzip_tpu_torch.io.fastq import ReadBatch
from bfqzip_tpu_torch.parallel import mesh
from bfqzip_tpu_torch.parallel.comm import Comm


def block_smooth_rank(seqs, quals, lengths, comm: Comm, cfg: SmoothConfig):
    """This rank's block (tensors on comm.device) through the single-device
    engine; returns (InvertOut, stats summed over the ranks)."""
    inv, stats = smooth_step(seqs, quals, lengths, cfg)
    return inv, {k: comm.psum(v) for k, v in stats.items()}


def _rank(comm, seqs, quals, lengths, out_seqs, out_quals, out_lengths, cfg):
    rows = seqs.shape[0] // comm.d
    lo, hi = comm.rank * rows, (comm.rank + 1) * rows
    inv, stats = block_smooth_rank(seqs[lo:hi].to(comm.device), quals[lo:hi].to(comm.device),
                                   lengths[lo:hi].to(comm.device), comm, cfg)
    out_seqs[lo:hi] = inv.seqs.cpu()
    out_quals[lo:hi] = inv.quals.cpu()
    out_lengths[lo:hi] = inv.lengths.cpu()
    return {k: int(v) for k, v in stats.items()}


def block_smooth_fastq(
    batch: ReadBatch, cfg: SmoothConfig, blocks: int, device="cuda",
    backend: str | None = None, work_dir: str | None = None,
) -> Tuple[ReadBatch, dict]:
    """Host wrapper: pad the batch to a multiple of `blocks` with dummy
    1-base 'A' reads of quality '!', run one block per spawned rank (on
    CUDA one card each, unless backend="gloo"), and return the reads in
    input order with the summed stats."""
    n = batch.num_reads
    pad = (-n) % blocks
    seqs = np.pad(batch.seqs, ((0, pad), (0, 0)))
    quals = np.pad(batch.quals, ((0, pad), (0, 0)))
    lengths = np.pad(batch.lengths.astype(np.int32), (0, pad), constant_values=1)
    if pad:
        seqs[n:, 0] = alphabet.A  # keeps the dummy reads valid
        quals[n:, 0] = ord("!")  # lowest quality: dummies never look trusted
    shared = [torch.from_numpy(a).share_memory_() for a in (seqs, quals, lengths)]
    outs = [torch.zeros_like(t).share_memory_() for t in shared]
    stats = mesh.spawn(_rank, blocks, device, work_dir or tempfile.gettempdir(),
                       args=(*shared, *outs, cfg), backend=backend)[0]
    out = ReadBatch(seqs=outs[0][:n].numpy(), quals=outs[1][:n].numpy(),
                    lengths=outs[2][:n].numpy(), headers=batch.headers)
    return out, stats

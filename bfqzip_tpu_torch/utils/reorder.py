"""Read reordering to boost compression of independently-coded blocks (the
port's copy of bfqzip_tpu/utils/reorder.py).

The reference offers two pre-compression reorders (BFQzip_parallel.py:59-75):
random shuffling (randomFASTQ.py:52-102) and SPRING's reorder-only mode
(clustering similar reads together).  Here:

  mode 1 — random permutation (same contract as randomFASTQ.py; paired mode
           applies one permutation to both mates)
  mode 2 — similarity reorder: MINIMIZER clustering — each read is keyed by
           the minimum hash over its 16-mers and reads are sorted by
           (minimizer, minimizer-offset descending), so reads covering the
           same locus land adjacently AND in approximate genome order — the
           single-pass analog of SPRING's minhash-cluster reorder.  Measured
           on 100K-read ~34x Illumina-like data, mode 2, 8 independent
           blocks (BASELINE.md): total compressed 5.00 MB unordered ->
           2.46 MB with this order (the round-1 32bp-prefix lexsort
           stand-in: 4.78 MB).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from bfqzip_tpu_torch.io.fastq import ReadBatch


def reorder_permutation(batch: ReadBatch, mode: int, seed: int = 0) -> np.ndarray:
    if mode == 1:
        rng = np.random.default_rng(seed)
        return rng.permutation(batch.num_reads)
    if mode == 2:
        return _minimizer_order(batch)
    raise ValueError(f"unknown reorder mode {mode}")


def _minimizer_order(batch: ReadBatch, k: int = 16) -> np.ndarray:
    """Sort reads by (min 16-mer hash, offset of that 16-mer, descending).

    Reads sampled from the same locus share the locus's minimizer, and the
    descending offset puts upstream reads first — consecutive reads overlap,
    which is what both the block-mode EBWTs and the match-model coder
    exploit.  Short reads (< k) sort by their first symbols."""
    codes = batch.seqs.astype(np.int64)  # 0..5 (0 = pad)
    N, L = codes.shape
    if L < k:
        cols = [codes[:, i] for i in range(L - 1, -1, -1)]
        return np.lexsort(cols)
    w = L - k + 1
    val = np.zeros((N, w), np.int64)
    for j in range(k):
        val = val * 6 + codes[:, j : j + w]
    h = (val * np.int64(-0x61C8864680B583EB)) & np.int64(0x7FFFFFFFFFFFFFFF)
    # k-mers hanging past the read end (pad symbols) must not win
    offs = np.arange(w)[None, :]
    valid = offs <= (batch.lengths[:, None] - k)
    h = np.where(valid, h, np.int64(0x7FFFFFFFFFFFFFFF))
    mini = h.min(axis=1)
    pos = h.argmin(axis=1)
    return np.lexsort((-pos, mini))


def apply_permutation(batch: ReadBatch, perm: np.ndarray) -> ReadBatch:
    headers = [batch.headers[i] for i in perm] if batch.headers is not None else None
    return ReadBatch(
        seqs=batch.seqs[perm],
        quals=batch.quals[perm],
        lengths=batch.lengths[perm],
        headers=headers,
    )


def reorder_batch(
    batch: ReadBatch, mode: int, mate: Optional[ReadBatch] = None, seed: int = 0
):
    """Reorder a batch (and optionally its mate with the same permutation,
    randomFASTQ.py paired contract)."""
    perm = reorder_permutation(batch, mode, seed)
    out = apply_permutation(batch, perm)
    if mate is not None:
        return out, apply_permutation(mate, perm)
    return out

"""Debug / inspection outputs, mirroring the reference's -D/-V modes (the
port's copy of bfqzip_tpu/utils/debug.py, with the one helper it needs from
bfqzip_tpu/ref_golden.py).

The reference can print, per BWT position, the read coordinate, original and
modified base/quality and the LCP>=K / minimum flags (bfq_int.cpp:829-862),
plus a cluster-size histogram (bfq_int.cpp:677-736) and before/after quality
distributions (bfq_int.cpp:1022-1053).  Here the same artifacts are produced
from the device arrays.
"""

from __future__ import annotations

from typing import Dict, Optional, TextIO, Tuple

import numpy as np

from bfqzip_tpu_torch import alphabet
from bfqzip_tpu_torch.config import SmoothConfig


def lcp_bitvectors(lcp: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """LCP_threshold and LCP_minima.

    threshold[i] = LCP[i] >= K  (update_LCP_leaf / update_lcp_threshold,
    include.hpp:888-925).

    minima[p] = LCP[p] < LCP[p-1] and LCP[p+1] >= LCP[p], p in [1, n-2]
    — the LCP-array form of update_lcp_minima (bfq_int.cpp:147-181).
    """
    n = lcp.size
    thr = lcp >= k
    minima = np.zeros(n, dtype=bool)
    if n >= 3:
        p = np.arange(1, n - 1)
        minima[1:-1] = (lcp[p] < lcp[p - 1]) & (lcp[p + 1] >= lcp[p])
    return thr, minima


def position_dump(
    bwt: np.ndarray,
    bwt_sub: np.ndarray,
    qs_before: np.ndarray,
    qs_after: np.ndarray,
    lcp: np.ndarray,
    cfg: SmoothConfig,
    out: TextIO,
    limit: Optional[int] = None,
) -> None:
    """TSV: position, original/modified base, original/modified QS, flags."""
    thr, minima = lcp_bitvectors(lcp.astype(np.int64), cfg.k)
    n = bwt.size if limit is None else min(limit, bwt.size)
    dec = alphabet.decode(np.minimum(bwt, alphabet.SIGMA - 1))
    dec_sub = alphabet.decode(np.minimum(bwt_sub, alphabet.SIGMA - 1))
    out.write("pos\tbwt\tmodified\tqs\tmodified.qs\tLCP>=K\tminimum\n")
    for i in range(n):
        out.write(
            f"{i}\t{chr(dec[i])}\t{chr(dec_sub[i])}\t{chr(qs_before[i])}\t"
            f"{chr(qs_after[i])}\t{'+' if thr[i] else ''}\t{'*' if minima[i] else ''}\n"
        )


def qs_distribution(qs: np.ndarray, nonterm_mask: np.ndarray) -> Dict[int, int]:
    """Absolute quality frequencies (statistics_qual_* of the reference)."""
    vals, counts = np.unique(qs[nonterm_mask], return_counts=True)
    return {int(v): int(c) for v, c in zip(vals, counts)}


def cluster_size_histogram(lcp: np.ndarray, cfg: SmoothConfig, max_size: int = 200) -> np.ndarray:
    """Histogram of processed-cluster sizes (bfq_int.cpp:677-736)."""
    thr, minima = lcp_bitvectors(lcp.astype(np.int64), cfg.k)
    pred = thr & ~minima
    d = np.diff(pred.astype(np.int8))
    rs = np.flatnonzero(d == 1) + 1
    re = np.flatnonzero(d == -1)
    if pred.size and pred[0]:
        rs = np.concatenate(([0], rs))
    if pred.size and pred[-1]:
        re = np.concatenate((re, [pred.size - 1]))
    hist = np.zeros(max_size + 1, np.int64)
    for a, b in zip(rs, re):
        size = b - max(a - cfg.border, 0) + 1
        if cfg.min_cluster <= size <= max_size:
            hist[size] += 1
    return hist


def format_histogram(hist: np.ndarray, width: int = 100) -> str:
    scale = max(int(hist.max()), 1)
    lines = []
    for i, v in enumerate(hist):
        if v:
            bar = "-" * (width * int(v) // scale)
            lines.append(f"{i:<4}{bar} {int(v)}")
    return "\n".join(lines)

"""Positional clustering + noise reduction + quality smoothing in PyTorch.

Port of bfqzip_tpu/ops/smooth.py (see its docstring for the derivation):
clusters, per-cluster totals and per-cluster decisions are all segmented
scans over the whole EBWT (`ops`, a scan toolbox such as
ops.scan.LocalScanOps), the 30-bit decision word is packed at each cluster
close, broadcast over the members by one reversed keep-left scan, and
applied elementwise.  The bit layout is the JAX package's.

Mode 1 (mean error) always runs in float64.  Its per-quality error
10^(-(q-33)/10) comes from a 256-entry table computed on the host, and the
rounding -10*log10(avg) to an integer quality is read off host-computed
thresholds, so the result does not depend on the device's pow/log10.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from bfqzip_tpu_torch import alphabet
from bfqzip_tpu_torch.config import SmoothConfig
from bfqzip_tpu_torch.ops.rank import lf_array
from bfqzip_tpu_torch.ops.scan import LOCAL_OPS
from bfqzip_tpu_torch.ops.suffix import EbwtDevice

# reference ord order: index o -> alphabet code
_ORD_CODES = (alphabet.A, alphabet.C, alphabet.G, alphabet.T, alphabet.N)
_N_ORD = 4  # index of 'N' in ord order
# code -> ord (TERM/PAD -> 0, harmless under masks)
_CODE2ORD = (0, 0, 1, 2, 4, 3, 0, 0)

# decision-word bit layout
_B_SINGLE = 0
_B_TWO = 1
_B_SSYM = 2  # 3 bits
_B_F0 = 5  # 3 bits
_B_F1 = 8  # 3 bits
_B_P0 = 11  # 3 bits
_B_P1 = 14  # 3 bits
_B_NEWQS = 17  # 8 bits
_B_HIGH = 25  # 5 bits, ord order


class SmoothOut(NamedTuple):
    bwt_sub: torch.Tensor  # [n_pad] u8, base-corrected BWT
    qs: torch.Tensor  # [n_pad] u8, smoothed qualities
    stats: dict  # reference counters, scalar tensors


def _i32(b: torch.Tensor) -> torch.Tensor:
    return b.to(torch.int32)


# g(a) = floor(-10*log10(max(a, 1e-300)) + 0.5) is non-increasing in a; its
# thresholds T_v = min{a : g(a) <= v} cover every v whose quality v+33
# survives the [0, 255] clip
_M1_VMIN, _M1_VMAX = -33, 255 - 33


def _m1_round(a: float) -> int:
    return math.floor(-10.0 * math.log10(max(a, 1e-300)) + 0.5)


@functools.lru_cache(maxsize=None)
def _m1_tables() -> tuple:
    """(err[256], thresholds ascending) in float64, on the host's libm."""
    err = np.array([10.0 ** (-(q - 33.0) / 10.0) for q in range(256)], np.float64)
    lo_bits = np.float64(1e-300).view(np.int64).item()
    hi_bits = np.float64(1e300).view(np.int64).item()
    thr = []
    for v in range(_M1_VMIN, _M1_VMAX + 1):
        lo, hi = lo_bits, hi_bits  # positive doubles order as their bit patterns
        while lo < hi:  # smallest a with g(a) <= v
            mid = (lo + hi) // 2
            if _m1_round(np.int64(mid).view(np.float64).item()) <= v:
                hi = mid
            else:
                lo = mid + 1
        thr.append(np.int64(lo).view(np.float64).item())
    return err, np.array(sorted(thr), np.float64)


def _mean_error_quality(qs, keep, c_esum_fn, safe_basenum):
    err_t, thr_t = _m1_tables()
    dev = qs.device
    err = torch.as_tensor(err_t, device=dev)[qs.long()]
    err = torch.where(keep, err, torch.zeros((), dtype=torch.float64, device=dev))
    avg = c_esum_fn(err) / safe_basenum.to(torch.float64)
    thr = torch.as_tensor(thr_t, device=dev)
    # g(avg) = VMIN + #{v : avg < T_v}
    above = thr.numel() - torch.searchsorted(thr, avg, right=True)
    return _M1_VMIN + above.to(torch.int32) + 33


def lf_and_pre(bwt: torch.Tensor, n: torch.Tensor, ops=None) -> tuple:
    """(LF, pre = bwt[LF]) of an EBWT that carries no suffix array, as the
    cached-artifact path's is; positions at or past `n` keep LF[i] = i."""
    ops = ops or LOCAL_OPS
    lf = lf_array(bwt, ops.iota(bwt.shape[0], bwt.device) < n, ops)
    return lf, bwt[lf]


def smooth(ebwt: EbwtDevice, cfg: SmoothConfig, pre: torch.Tensor | None = None, ops=None) -> SmoothOut:
    """Smooth the EBWT; `pre` is the symbol preceding each BWT position
    (EbwtDevice.pre of the flat build).  Without it, pre comes from
    lf_and_pre."""
    ops = ops or LOCAL_OPS
    bwt, qs, lcp, n = ebwt.bwt, ebwt.qs, ebwt.lcp, ebwt.n
    if pre is None:
        _, pre = lf_and_pre(bwt, n, ops)
    word, close_mark, in_cluster, stats = cluster_words(bwt, qs, lcp, n, cfg, pre, ops)
    # broadcast the close-position word back over the cluster members with a
    # keep-left segmented scan from the right
    w = ops.next_marked(torch.where(close_mark, word, 0), close_mark, init=0)
    bwt_sub, qs_out, modified, qs_smoothed = apply_words(bwt, qs, pre, w, in_cluster, cfg)
    stats["modified"] = ops.sum(_i32(modified))
    stats["qs_smoothed"] = ops.sum(_i32(qs_smoothed))
    return SmoothOut(bwt_sub=bwt_sub, qs=qs_out, stats=stats)


def cluster_words(bwt, qs, lcp, n, cfg: SmoothConfig, pre, ops) -> tuple:
    """Cluster detection + per-cluster decisions, all in scan form.

    Returns (word, close_mark, in_cluster, stats) as the JAX version does.
    """
    n_pad = bwt.shape[0]
    dev = bwt.device
    pos = ops.iota(n_pad, dev)
    valid = pos < n
    m = cfg.min_cluster

    # ---- bitvectors via the LCP array ----
    thr = (lcp >= cfg.k) & valid
    lcp_prev = ops.shift_prev(lcp, 0)
    lcp_next = ops.shift_next(lcp, 0)
    minima = (lcp < lcp_prev) & (lcp_next >= lcp) & (pos >= 1) & (pos <= n - 2)
    pred = thr & ~minima

    # ---- eligible runs -> clusters [run_start-1, run_end] ----
    pred_prev = ops.shift_prev(pred, False)
    pred_next = ops.shift_next(pred, False)
    rs_mark = pred & ~pred_prev
    ext = pred
    for t in range(1, max(m - 1, 1)):
        ext = ext & ops.shift_next_k(pred, t, False)
    elig_start = rs_mark & ext
    run_start = ops.cummax(torch.where(elig_start, pos, -1))
    in_run_elig = pred & (run_start >= 0) & (run_start <= pos)
    last_gap = ops.cummax(torch.where(~pred, pos, -1))
    in_run_elig = in_run_elig & (run_start > last_gap)

    open_mark = ~pred & ops.shift_next(in_run_elig, False)
    in_cluster = in_run_elig | open_mark
    close_mark = in_run_elig & ~pred_next

    nonterm_pos = (bwt != alphabet.TERM) & (bwt != alphabet.SIGMA)
    qt = cfg.quality_threshold + 33

    # ---- per-cluster totals: one [5, n] segmented cumsum of symbol counts,
    # one segmented OR of the 21 presence bits, read at closes ----
    mask_i = in_cluster
    acgt = (alphabet.A, alphabet.C, alphabet.G, alphabet.T)
    X = _i32(torch.stack([mask_i & (bwt == code) for code in _ORD_CODES], dim=0))
    S = ops.seg_cumsum(X, open_mark)
    del X
    c_freq = [S[o] for o in range(5)]

    pmask = torch.zeros(n_pad, dtype=torch.int32, device=dev)
    for o, code in enumerate(_ORD_CODES):
        pmask |= _i32((bwt == code) & (qs >= qt)) << o
    for si, s in enumerate(acgt):
        for d_i, d in enumerate(acgt):
            pmask |= _i32((bwt == s) & (pre == d)) << (5 + 4 * si + d_i)
    ors = ops.seg_cumor(torch.where(mask_i, pmask, 0), open_mark)
    del pmask
    # presence bits are read from `ors` where used: 21 materialised int32
    # rows would cost 84 B/position

    c_basenum = c_freq[0] + c_freq[1] + c_freq[2] + c_freq[3] + c_freq[4]
    safe_basenum = torch.clamp_min(c_basenum, 1)

    # ---- replacement quality newqs ----
    keep = mask_i & nonterm_pos
    if cfg.mode == 2:
        c_newqs = torch.full((n_pad,), cfg.default_qs, dtype=torch.int32, device=dev)
    elif cfg.mode == 0:
        c_newqs = ops.seg_cummax(torch.where(keep, _i32(qs), 0), open_mark)
    elif cfg.mode == 3:
        qsum = ops.seg_cumsum(torch.where(keep, _i32(qs), 0), open_mark)
        c_newqs = torch.div(qsum, safe_basenum, rounding_mode="floor")
    else:
        c_newqs = _mean_error_quality(
            qs, keep, lambda err: ops.seg_scan(err, open_mark, "add", 0.0), safe_basenum
        )

    # ---- frequent symbols (integer percentage) ----
    c_isfreq = [
        (torch.div(100 * f, safe_basenum, rounding_mode="floor") >= cfg.freq_threshold) & (f > 0)
        for f in c_freq
    ]
    c_nfreq = sum(_i32(f) for f in c_isfreq)
    c_f0 = torch.full((n_pad,), 5, dtype=torch.int32, device=dev)
    c_f1 = torch.full((n_pad,), -1, dtype=torch.int32, device=dev)
    for o in range(4, -1, -1):
        c_f0 = torch.where(c_isfreq[o], o, c_f0)
    for o in range(5):
        c_f1 = torch.where(c_isfreq[o], o, c_f1)
    codes_arr = list(_ORD_CODES) + [0]  # index 5 -> harmless 0
    c_f0_code = torch.zeros(n_pad, dtype=torch.int32, device=dev)
    c_f1_code = torch.zeros(n_pad, dtype=torch.int32, device=dev)
    c_f1_clamped = torch.clamp_min(c_f1, 0)
    for o in range(5):
        c_f0_code = torch.where(c_f0 == o, codes_arr[o], c_f0_code)
        c_f1_code = torch.where(c_f1_clamped == o, codes_arr[o], c_f1_code)

    c_has_bases = c_basenum > 0

    c_single1 = c_has_bases & (c_nfreq == 1) & (c_f0 != _N_ORD)
    c_single2 = c_has_bases & (c_nfreq == 2) & (c_basenum >= m) & (c_f1 == _N_ORD)
    c_single = c_single1 | c_single2
    c_two = c_has_bases & (c_nfreq == 2) & (c_basenum >= m) & (c_f1 != _N_ORD)

    # ---- two-frequent-symbol rule: unique distinct predecessors ----
    def sel_row(fc):
        rows = []
        for d in range(4):
            r = torch.zeros(n_pad, dtype=torch.int32, device=dev)
            for si, s in enumerate(acgt):
                r = torch.where(fc == s, (ors >> (5 + 4 * si + d)) & 1, r)
            rows.append(r)
        return rows

    u0 = sel_row(c_f0_code)
    u1 = sel_row(c_f1_code)
    c_u0sum = u0[0] + u0[1] + u0[2] + u0[3]
    c_u1sum = u1[0] + u1[1] + u1[2] + u1[3]
    pred_codes = (alphabet.A, alphabet.C, alphabet.G, alphabet.T)
    c_p0 = torch.zeros(n_pad, dtype=torch.int32, device=dev)
    c_p1 = torch.zeros(n_pad, dtype=torch.int32, device=dev)
    for d in range(3, -1, -1):
        c_p0 = torch.where(u0[d] > 0, pred_codes[d], c_p0)
        c_p1 = torch.where(u1[d] > 0, pred_codes[d], c_p1)
    c_p0 = torch.where(c_u0sum == 1, c_p0, 0)
    c_p1 = torch.where(c_u1sum == 1, c_p1, 0)
    c_two_ok = c_two & (c_u0sum == 1) & (c_u1sum == 1) & (c_p0 != c_p1)

    # ---- pack per-cluster decisions into one word at the close position ----
    high_bits = (ors & 0x1F) << _B_HIGH  # trusted-base presence, ord order
    word = (
        _i32(c_single) << _B_SINGLE
        | _i32(c_two_ok) << _B_TWO
        | c_f0_code << _B_SSYM  # ssym == FreqSymb[0] for both single cases
        | c_f0_code << _B_F0
        | c_f1_code << _B_F1
        | c_p0 << _B_P0
        | c_p1 << _B_P1
        | torch.clamp(c_newqs, 0, 255) << _B_NEWQS
        | high_bits
    )
    # ---- counters, summed at close marks ----
    c_nnn = sum(_i32(f > 0) for f in c_freq)
    c_disc = c_has_bases & (
        (c_nfreq == 0)
        | ((c_nfreq == 1) & (c_f0 == _N_ORD))
        | ((c_nfreq == 2) & (c_basenum < m))
    )

    def ccount(mask):
        return ops.sum(_i32(mask & close_mark))

    stats = {
        "num_clust": ops.sum(_i32(close_mark)),
        "num_clust_discarded": ccount(c_disc),
        "num_clust_amb_discarded": ccount(c_two & ~c_two_ok),
        "num_clust_mod": ccount(c_single2 | c_two_ok),
        "num_clust_alleq": ccount(c_has_bases & (c_nnn == 1)),
        "bases_inside": ops.sum(torch.where(close_mark, c_basenum, 0)),
    }
    return word, close_mark, in_cluster, stats


def apply_words(bwt, qs, pre, w, in_cluster, cfg: SmoothConfig) -> tuple:
    """Apply broadcast decision words w to every cluster member (elementwise).

    Returns (bwt_sub, qs_out, modified_mask, smoothed_mask)."""
    nonterm_pos = (bwt != alphabet.TERM) & (bwt != alphabet.SIGMA)
    apply_mask = in_cluster & nonterm_pos
    cl_single = ((w >> _B_SINGLE) & 1) == 1
    cl_two_ok = ((w >> _B_TWO) & 1) == 1
    cl_ssym = ((w >> _B_SSYM) & 7).to(torch.uint8)
    cl_f0 = ((w >> _B_F0) & 7).to(torch.uint8)
    cl_f1 = ((w >> _B_F1) & 7).to(torch.uint8)
    cl_p0 = ((w >> _B_P0) & 7).to(torch.uint8)
    cl_p1 = ((w >> _B_P1) & 7).to(torch.uint8)
    cl_newqs = ((w >> _B_NEWQS) & 0xFF).to(torch.uint8)
    code2ord = torch.tensor(_CODE2ORD, dtype=torch.int32, device=bwt.device)
    ord_of = code2ord[bwt.long()]
    cl_high_own = (w >> (_B_HIGH + ord_of)) & 1

    # single-symbol case
    s_act = apply_mask & cl_single
    s_replace = s_act & (bwt != cl_ssym) & (cl_high_own == 0)
    s_qs_const = s_act & (bwt == cl_ssym)
    s_qs_min = s_act & (bwt != cl_ssym) & (cl_high_own == 1) & (cl_newqs < qs)

    # two-frequent case
    t_act = apply_mask & cl_two_ok
    t_isf = (bwt == cl_f0) | (bwt == cl_f1)
    t_candidate = t_act & ~t_isf & (cl_high_own == 0)
    t_rep0 = t_candidate & (pre == cl_p0)
    t_rep1 = t_candidate & (pre == cl_p1) & ~t_rep0
    t_qs_const = t_act & t_isf
    t_qs_min = t_act & ~t_isf & (cl_high_own == 1) & (cl_newqs < qs)

    bwt_sub = torch.where(s_replace, cl_ssym, bwt)
    bwt_sub = torch.where(t_rep0, cl_f0, bwt_sub)
    bwt_sub = torch.where(t_rep1, cl_f1, bwt_sub)
    smoothed = s_qs_const | s_qs_min | t_qs_const | t_qs_min
    qs_out = torch.where(smoothed, cl_newqs, qs)
    modified = s_replace | t_rep0 | t_rep1
    return bwt_sub, qs_out, modified, smoothed

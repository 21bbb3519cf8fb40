"""EBWT + quality permutation + LCP construction (flat path) in PyTorch.

Port of bfqzip_tpu/ops/suffix.py::_build_ebwt_flat, for batches of width
up to 323 (width + 1 <= 324, the JAX dispatch's bound).
Position g = r*(L+1) + k is suffix k of read r (k == len_r is the read's
terminator suffix); padding slots (k > len_r) sort after every real suffix,
so the n real suffixes occupy SA[0:n].

Each suffix's whole window of L+1 symbols is packed into int64 words of 24
base-6 digits (6^24 < 2^63; terminator and padding are digit 0 < bases
1..5), because torch has no uint32 arithmetic.  Suffix order is realised by
least-significant-word-first STABLE sorts starting from position order,
which gives the JAX sort's tie-break (position as the last key): equal
windows imply equal distance to the terminator, so position order is read
order, gsufsort's distinct-terminator convention.  BWT, QS and the
smoother's predecessor symbols are gathered through the permutation.  LCP
is the count of leading equal nonzero digits of adjacent sorted keys.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from bfqzip_tpu import alphabet

PACK6 = 24  # base-6 digits per int64 key word
FLAT_MAX_WINDOW = 324  # the JAX flat path's limit (PACK6 * MAX_FLAT_WORDS): width + 1 <= 324
_PAD_KEY = torch.iinfo(torch.int64).max  # above every 24-digit word


class EbwtDevice(NamedTuple):
    """Step-1 artifacts; valid data occupies [0, n) of each array."""

    bwt: torch.Tensor  # [n_pad] u8 codes; SIGMA past n
    qs: torch.Tensor  # [n_pad] u8 raw ASCII quality bytes (filler at TERM positions)
    lcp: torch.Tensor  # [n_pad] i32 (lcp[0] == 0; 0 past n)
    sa: torch.Tensor  # [n_pad] i32 positions into the padded text
    text: torch.Tensor  # [n_pad] u8: 1+code per base, 0 at terminator/padding slots
    n: torch.Tensor  # scalar i32: number of real BWT positions
    pre: Optional[torch.Tensor] = None  # [n_pad] u8: symbol at SA[i]-2


def build_ebwt(seqs: torch.Tensor, quals: torch.Tensor, lengths: torch.Tensor) -> EbwtDevice:
    """EBWT, QS and LCP of a padded [N, L] read batch on the batch's device.

    Rows of length -1 are inert dummies (no terminator, no suffixes).
    """
    if seqs.shape[1] + 1 > FLAT_MAX_WINDOW:
        raise NotImplementedError(
            f"reads of {seqs.shape[1]} bp need the prefix-doubling build, which "
            f"is not ported yet (the flat path covers widths up to {FLAT_MAX_WINDOW - 1})"
        )
    return _build_ebwt_flat(seqs, quals, lengths)


def _pack_words(seqs: torch.Tensor, lens: torch.Tensor, wp: int, n_words: int) -> list:
    """[n_pad] int64 keys: word w holds symbols k+24w .. k+24w+23 of each window."""
    ext = PACK6 * n_words
    dev = seqs.device
    k = torch.arange(wp + ext, dtype=torch.int64, device=dev)[None, :]
    base6 = torch.nn.functional.pad(seqs.to(torch.int32), (0, 1 + ext))
    d = torch.where(k < lens[:, None], base6, torch.zeros((), dtype=torch.int32, device=dev))
    # c4[k] packs digits k..k+3 and c12[k] digits k..k+11, so a 24-digit word
    # is c12[k] * 6^12 + c12[k+12]
    c4 = ((d[:, :-3] * 6 + d[:, 1:-2]) * 6 + d[:, 2:-1]) * 6 + d[:, 3:]
    del d
    c12 = (c4[:, :-8].to(torch.int64) * 6**4 + c4[:, 4:-4]) * 6**4 + c4[:, 8:]
    del c4
    return [
        (c12[:, o : o + wp] * 6**12 + c12[:, o + 12 : o + 12 + wp]).reshape(-1)
        for o in range(0, ext, PACK6)
    ]


def _lcp(skeys: list, sa: torch.Tensor, lens: torch.Tensor, wp: int, valid: torch.Tensor) -> torch.Tensor:
    """Leading equal nonzero base-6 digits of each sorted key and its predecessor.

    A window's digits are nonzero up to its terminator and zero after it, so
    the count is min(first differing digit, predecessor's distance to its
    terminator).  The first differing digit is 24 * (leading equal words)
    plus a binary search for the leading equal digits of the first differing
    word (digit prefixes of a word compare as floor divisions by powers of 6).
    """
    n_pad = sa.shape[0]
    dev = sa.device
    prev_keys = [torch.cat([w[:1], w[:-1]]) for w in skeys]
    fw = torch.zeros(n_pad, dtype=torch.int64, device=dev)  # leading equal words
    same = torch.ones(n_pad, dtype=torch.bool, device=dev)
    for a, b in zip(prev_keys, skeys):
        same &= a == b
        fw += same
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    a_w, b_w = zero.expand(n_pad), zero.expand(n_pad)
    for w, (a, b) in enumerate(zip(prev_keys, skeys)):
        at_w = fw == w
        a_w = torch.where(at_w, a, a_w)
        b_w = torch.where(at_w, b, b_w)
    del prev_keys
    pow6 = torch.tensor([6**e for e in range(PACK6 + 1)], dtype=torch.int64, device=dev)
    lo = torch.zeros(n_pad, dtype=torch.int64, device=dev)  # lo digits agree
    hi = torch.full((n_pad,), PACK6, dtype=torch.int64, device=dev)  # hi digits do not
    for _ in range(PACK6.bit_length()):
        mid = (lo + hi) // 2
        p = pow6[PACK6 - mid]
        agree = torch.div(a_w, p, rounding_mode="floor") == torch.div(b_w, p, rounding_mode="floor")
        lo = torch.where(agree, mid, lo)
        hi = torch.where(agree, hi, mid)
    first_diff = fw * PACK6 + lo
    sa_prev = torch.cat([sa[:1], sa[:-1]])
    to_term = lens[torch.div(sa_prev, wp, rounding_mode="floor")] - torch.remainder(sa_prev, wp)
    lcp = torch.minimum(first_diff, to_term).to(torch.int32)
    lcp = torch.where(valid, lcp, torch.zeros((), dtype=torch.int32, device=dev))
    lcp[0] = 0
    return lcp


def _build_ebwt_flat(seqs: torch.Tensor, quals: torch.Tensor, lengths: torch.Tensor) -> EbwtDevice:
    n_reads, width = seqs.shape
    dev = seqs.device
    wp = width + 1
    n_pad = n_reads * wp
    lens = lengths.to(torch.int64)
    n = (lens.clamp_min(0).sum() + (lens >= 0).sum()).to(torch.int32)
    n_words = -(-wp // PACK6)

    words = _pack_words(seqs, lens, wp, n_words)
    kk = torch.arange(wp, dtype=torch.int64, device=dev)[None, :]
    is_pad = (kk > lens[:, None]).reshape(-1)
    words[0] = torch.where(is_pad, torch.full((), _PAD_KEY, dtype=torch.int64, device=dev), words[0])

    # LSD: stable sorts from the last word to the first, starting from
    # position order; the last pass leaves word 0 sorted
    sa = torch.arange(n_pad, dtype=torch.int64, device=dev)
    for w in range(n_words - 1, -1, -1):
        key = words[w] if w == n_words - 1 else words[w][sa]
        sorted_key, order = torch.sort(key, stable=True)
        sa = sa[order]
    skeys = [sorted_key] + [words[w][sa] for w in range(1, n_words)]
    del words

    # text symbols (1+code, 0 at terminator/padding) and qualities
    zero8 = torch.zeros((), dtype=torch.uint8, device=dev)
    text_codes = torch.where(
        kk < lens[:, None], torch.nn.functional.pad(seqs.to(torch.uint8), (0, 1)) + 1, zero8
    )
    tflat = text_codes.reshape(-1)
    qtext = torch.nn.functional.pad(quals.to(torch.uint8), (0, 1)).reshape(-1)

    prev = torch.remainder(sa - 1, n_pad)
    cprev = tflat[prev]
    is_term = cprev == 0
    bwt = torch.where(is_term, torch.full((), alphabet.TERM, dtype=torch.uint8, device=dev), cprev - 1)
    qs = torch.where(
        is_term, torch.full((), alphabet.TERM_CHAR, dtype=torch.uint8, device=dev), qtext[prev]
    )
    c2 = tflat[torch.remainder(sa - 2, n_pad)]
    pre = torch.where(c2 == 0, torch.full((), alphabet.TERM, dtype=torch.uint8, device=dev), c2 - 1)

    valid = torch.arange(n_pad, dtype=torch.int64, device=dev) < n
    bwt = torch.where(valid, bwt, torch.full((), alphabet.SIGMA, dtype=torch.uint8, device=dev))
    qs = torch.where(valid, qs, zero8)
    lcp = _lcp(skeys, sa, lens, wp, valid)
    return EbwtDevice(
        bwt=bwt, qs=qs, lcp=lcp, sa=sa.to(torch.int32), text=tflat, n=n, pre=pre
    )

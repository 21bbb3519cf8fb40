"""EBWT + quality permutation + LCP construction in PyTorch.

Port of bfqzip_tpu/ops/suffix.py.  `build_ebwt` dispatches as the JAX
package does: the flat whole-window sort for width + 1 <= 324, prefix
doubling for longer reads.

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

The doubling path (long reads) packs 30 symbols at 3 bits per word, orders
round 0 by (w0, w1, w2, tie-break) with two LSD stable sorts of int64 keys,
then doubles the span 30 -> 60 -> ... with one stable sort of the int64 key
rank << 32 | (rank_ahead + 1) per round and dense re-ranking; its LCP is
binary lifting over the kept per-round ranks plus a count of leading equal
3-bit groups of the packed words.  Its keys are distinct by the last round
(every window reaches its read's terminator tile, whose tie-break is the
read index), so the JAX package's unstable sort and these stable ones give
the same SA.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from bfqzip_tpu_torch import alphabet
from bfqzip_tpu_torch.utils.profiling import span

PACK6 = 24  # base-6 digits per int64 key word
FLAT_MAX_WINDOW = 324  # the JAX flat path's limit (PACK6 * MAX_FLAT_WORDS): width + 1 <= 324
_PAD_KEY = torch.iinfo(torch.int64).max  # above every 24-digit word

# doubling path (the JAX package's layout)
PACK = 10  # symbols per packed word, 3 bits each
PACK_WORDS = 3  # words in the round-0 key
SPAN0 = PACK * PACK_WORDS
_EXT = SPAN0 + PACK  # row extension so every packed word reads in-row


class EbwtDevice(NamedTuple):
    """Step-1 artifacts; valid data occupies [0, n) of each array."""

    bwt: torch.Tensor  # [n_pad] u8 codes; SIGMA past n
    qs: torch.Tensor  # [n_pad] u8 raw ASCII quality bytes (filler at TERM positions)
    lcp: torch.Tensor  # [n_pad] i32 (lcp[0] == 0; 0 past n)
    sa: torch.Tensor  # [n_pad] i32 positions into the padded text
    text: torch.Tensor  # [n_pad] u8: 1+code per base, 0 at terminator/padding slots
    n: torch.Tensor  # scalar i32: number of real BWT positions
    pre: Optional[torch.Tensor] = None  # [n_pad] u8: symbol at SA[i]-2


def build_route(width: int) -> str:
    """The build that build_ebwt takes for a batch of this width: "flat"
    while the whole window fits (width + 1 <= 324), else "doubling"."""
    return "flat" if width + 1 <= FLAT_MAX_WINDOW else "doubling"


def build_ebwt(seqs: torch.Tensor, quals: torch.Tensor, lengths: torch.Tensor) -> EbwtDevice:
    """EBWT, QS and LCP of a padded [N, L] read batch on the batch's device.

    Rows of length -1 are inert dummies (no terminator, no suffixes).  The
    doubling build leaves `pre` None.
    """
    with span("suffix.build_ebwt"):
        if build_route(seqs.shape[1]) == "doubling":
            return _build_ebwt_doubling(seqs, quals, lengths)
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


def _lens_and_n(lengths: torch.Tensor) -> tuple:
    """(int64 read lengths, 0-d int32 count of real suffix positions): each
    read's bases plus its terminator; inert rows (length -1) have none."""
    lens = lengths.to(torch.int64)
    return lens, (lens.clamp_min(0).sum() + (lens >= 0).sum()).to(torch.int32)


def _pack(seqs: torch.Tensor, lens: torch.Tensor) -> list:
    """The flat build's [n_pad] int64 sort keys: each window's base-6 words,
    with word 0 of every padding slot set above every real key."""
    wp = seqs.shape[1] + 1
    dev = seqs.device
    words = _pack_words(seqs, lens, wp, -(-wp // PACK6))
    kk = torch.arange(wp, dtype=torch.int64, device=dev)[None, :]
    is_pad = (kk > lens[:, None]).reshape(-1)
    words[0] = torch.where(is_pad, torch.full((), _PAD_KEY, dtype=torch.int64, device=dev), words[0])
    return words


def _sort_lsd(words: list, stable: bool = True) -> tuple:
    """(sa, sorted keys): LSD stable sorts from the last word to the first,
    starting from position order; the last pass leaves word 0 sorted.
    stable=False runs the same passes unstably, which tools/*_sort_torch.py
    time against the build's: the suffix order needs stable passes."""
    n_words = len(words)
    sa = torch.arange(words[0].shape[0], dtype=torch.int64, device=words[0].device)
    for w in range(n_words - 1, -1, -1):
        key = words[w] if w == n_words - 1 else words[w][sa]
        sorted_key, order = torch.sort(key, stable=stable)
        sa = sa[order]
    return sa, [sorted_key] + [words[w][sa] for w in range(1, n_words)]


def _post(seqs: torch.Tensor, quals: torch.Tensor, lens: torch.Tensor, sa: torch.Tensor,
          n: torch.Tensor) -> tuple:
    """(bwt, qs, pre, text, valid) read through the suffix array: the text
    symbol and quality before each suffix, the symbol two before it, and
    the text itself (1+code, 0 at terminator/padding slots)."""
    wp = seqs.shape[1] + 1
    n_pad = sa.shape[0]
    dev = seqs.device
    kk = torch.arange(wp, dtype=torch.int64, device=dev)[None, :]
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
    return bwt, qs, pre, tflat, valid


def _build_ebwt_flat(seqs: torch.Tensor, quals: torch.Tensor, lengths: torch.Tensor) -> EbwtDevice:
    """The whole-window build in four steps: _pack, _sort_lsd, _post, _lcp."""
    wp = seqs.shape[1] + 1
    lens, n = _lens_and_n(lengths)
    with span("suffix.pack"):
        words = _pack(seqs, lens)
    with span("suffix.sort_lsd"):
        sa, skeys = _sort_lsd(words)
    del words
    with span("suffix.post"):
        bwt, qs, pre, tflat, valid = _post(seqs, quals, lens, sa, n)
    with span("suffix.lcp"):
        lcp = _lcp(skeys, sa, lens, wp, valid)
    return EbwtDevice(
        bwt=bwt, qs=qs, lcp=lcp, sa=sa.to(torch.int32), text=tflat, n=n, pre=pre
    )


def _window_codes(seqs: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """[N, wp + _EXT] u8 rows: 1 + code for bases, zeros from the terminator on."""
    wp = seqs.shape[1] + 1
    k = torch.arange(wp + _EXT, dtype=torch.int64, device=seqs.device)[None, :]
    base = torch.nn.functional.pad(seqs.to(torch.uint8), (0, 1 + _EXT)) + 1
    return torch.where(k < lens[:, None], base, torch.zeros((), dtype=torch.uint8, device=seqs.device))


def _pack_word(wcodes: torch.Tensor, wp: int, word: int) -> torch.Tensor:
    """[N * wp] i32 keys packing symbols [10 * word, 10 * word + 10) of each window."""
    o = PACK * word
    acc = torch.zeros(wcodes.shape[0], wp, dtype=torch.int32, device=wcodes.device)
    for t in range(PACK):
        acc |= wcodes[:, o + t : o + t + wp].to(torch.int32) << (3 * (PACK - 1 - t))
    return acc.reshape(-1)


def _rank_from_changes(changed: torch.Tensor, sa: torch.Tensor) -> torch.Tensor:
    """Dense ranks scattered back to position order: the rank of sorted slot
    i is the count of key changes at slots 1..i (changed[0] is ignored);
    sa is a permutation, so the scatter's indices are unique."""
    steps = changed.to(torch.int32)
    steps[0] = 0
    rank = torch.empty(sa.shape[0], dtype=torch.int32, device=sa.device)
    rank[sa] = torch.cumsum(steps, 0, dtype=torch.int32)
    return rank


def _dense_rank(sorted_key: torch.Tensor, sa: torch.Tensor) -> torch.Tensor:
    changed = torch.ones_like(sorted_key, dtype=torch.bool)
    changed[1:] = sorted_key[1:] != sorted_key[:-1]
    return _rank_from_changes(changed, sa)


def _spans(wp: int) -> list:
    spans = [SPAN0]
    while spans[-1] < wp:
        spans.append(spans[-1] * 2)
    return spans  # doubling rounds sort spans[1:]; ranks are kept for spans[:-1]


def _build_ebwt_doubling(seqs: torch.Tensor, quals: torch.Tensor, lengths: torch.Tensor) -> EbwtDevice:
    """Prefix-doubling construction for long reads; port of
    bfqzip_tpu/ops/suffix.py::_build_ebwt_doubling (see the module docstring)."""
    n_reads, width = seqs.shape
    dev = seqs.device
    wp = width + 1
    n_pad = n_reads * wp
    if n_pad + n_reads + 1 >= 1 << 33:
        raise ValueError(f"{n_pad} suffix positions overflow the 33-bit round-0 tie-break")
    lens, n = _lens_and_n(lengths)

    wcodes = _window_codes(seqs, lens)
    words = [_pack_word(wcodes, wp, w) for w in range(PACK_WORDS)]
    del wcodes
    k = torch.arange(wp, dtype=torch.int64, device=dev)[None, :]
    rid = torch.arange(n_reads, dtype=torch.int64, device=dev)[:, None]
    is_pad = k > lens[:, None]
    dist = lens[:, None] - k  # distance to the terminator
    # tie-break: the read index when the terminator lies inside the packed
    # span (prefix-equal reads order by index); unique values above every
    # read for padding, whose first word is forced to the maximum
    tb = torch.where((dist >= 0) & (dist < SPAN0), rid + 1, 0)
    tb = torch.where(is_pad, n_reads + 1 + rid * wp + k, tb).reshape(-1)
    w0 = torch.where(is_pad.reshape(-1), 1 << 30, words[0]).to(torch.int64)
    del dist, rid

    # round 0: keys (w0 << 30 | w1, w2 << 33 | tb), least significant first,
    # stable from position order
    lo_key = (words[2].to(torch.int64) << 33) | tb
    hi_key = (w0 << 30) | words[1].to(torch.int64)
    del tb, w0, words[1:]
    _, sa = torch.sort(lo_key, stable=True)
    sorted_hi, order = torch.sort(hi_key[sa], stable=True)
    sa = sa[order]
    del hi_key, order
    # equal (hi, lo) pairs share a rank: fold "lo changed" into the hi key's
    # change test through the sorted lo keys
    sorted_lo = lo_key[sa]
    del lo_key
    changed = torch.ones(n_pad, dtype=torch.bool, device=dev)
    changed[1:] = (sorted_hi[1:] != sorted_hi[:-1]) | (sorted_lo[1:] != sorted_lo[:-1])
    del sorted_hi, sorted_lo
    rank = _rank_from_changes(changed, sa)
    del changed

    spans = _spans(wp)
    ranks = [rank]  # ranks[i]: the rank of each position's span spans[i]
    for i, h in enumerate(spans[:-1]):
        ahead = torch.full((n_pad,), -1, dtype=torch.int64, device=dev)
        ahead[: max(n_pad - h, 0)] = rank[h:]
        key = (rank.to(torch.int64) << 32) | (ahead + 1)
        del ahead
        sorted_key, sa = torch.sort(key, stable=True)
        del key
        if i + 1 < len(spans) - 1:  # the final span's rank is never used
            rank = _dense_rank(sorted_key, sa)
            ranks.append(rank)
        del sorted_key

    # ---- BWT + permuted qualities (a padding predecessor only precedes a
    # read's first suffix, whose true predecessor is a terminator) ----
    zero8 = torch.zeros((), dtype=torch.uint8, device=dev)
    text_codes = torch.where(
        k < lens[:, None], torch.nn.functional.pad(seqs.to(torch.uint8), (0, 1)) + 1, zero8
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
    del prev, cprev, is_term, qtext
    valid = torch.arange(n_pad, dtype=torch.int64, device=dev) < n
    bwt = torch.where(valid, bwt, torch.full((), alphabet.SIGMA, dtype=torch.uint8, device=dev))
    qs = torch.where(valid, qs, zero8)

    # ---- LCP by binary lifting over the doubling ranks ----
    a = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), sa[:-1]])
    b = sa
    h = torch.zeros(n_pad, dtype=torch.int64, device=dev)
    last = n_pad - 1
    for span, r in zip(reversed(spans[:-1]), reversed(ranks)):
        ah, bh = a + h, b + h
        same = (ah < n_pad) & (bh < n_pad) & (r[ah.clamp_max(last)] == r[bh.clamp_max(last)])
        h = torch.where(same, h + span, h)
        del ah, bh, same
    del ranks
    # the remainder (< SPAN0 symbols) from the unmasked packed words: leading
    # equal 3-bit groups, gated at the first zero group (the terminator); the
    # gathers stay 1-D
    rem = torch.zeros(n_pad, dtype=torch.int32, device=dev)
    nz = torch.ones(n_pad, dtype=torch.bool, device=dev)
    eq = torch.ones(n_pad, dtype=torch.bool, device=dev)
    for w in range(PACK_WORDS):
        aw = words[0][(a + h + PACK * w).clamp_max(last)]
        bw = words[0][(b + h + PACK * w).clamp_max(last)]
        for j in range(1, PACK + 1):
            sh = 3 * (PACK - j)
            eq &= (aw >> sh) == (bw >> sh)
            nz &= ((aw >> sh) & 7) != 0
            rem += eq & nz
    lcp = (h + rem).to(torch.int32)
    lcp = torch.where(valid, lcp, torch.zeros((), dtype=torch.int32, device=dev))
    lcp[0] = 0
    return EbwtDevice(bwt=bwt, qs=qs, lcp=lcp, sa=sa.to(torch.int32), text=tflat, n=n)

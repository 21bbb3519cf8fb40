"""Sequence-sharded EBWT construction: ONE global suffix sort across ranks.

Port of bfqzip_tpu/parallel/global_ebwt.py (see its docstring for the
design).  The padded position space n_pad = N*(L+1) is split contiguously
over the d ranks of a Comm (each rank owns whole reads), and:

  * reads with width + 1 <= 120 take the flat body: every suffix's whole
    window packs into <= 5 base-6 int64 words, so suffix order is ONE
    distributed sample sort of (words..., position) rows, with BWT, QS and
    the smoother's predecessor symbols riding the exchange as one payload;
  * longer reads take prefix doubling: each round is a distributed sample
    sort of int64 (rank << 31 | rank_ahead + 2) keys, rank_ahead comes from
    a halo with the next rank, and dense ranks are routed back to their
    position shards; BWT/QS and the LCP's lifting use routed global gathers.

`Ctx` is the collective toolbox (bucket exchange, distributed sort, routed
gather and scatter, exact rebalance) shared with parallel/global_pipeline.py.

Buffers in sorted order have a fixed capacity per rank (the sample sort
balances only approximately), with a count of valid slots.  An exchange
bucket that overflows is reported, never silent: the wrappers retry with
doubled capacity.  Invalid lanes of a scatter aim at one extra slot past the
end, which is dropped (the counterpart of XLA's mode="drop"); only invalid
lanes share that slot.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from bfqzip_tpu_torch import alphabet
from bfqzip_tpu_torch.ops.suffix import PACK, _pack_word, _pack_words, _window_codes
from bfqzip_tpu_torch.parallel.comm import Comm

I64_MAX = torch.iinfo(torch.int64).max
I32_MAX = torch.iinfo(torch.int32).max
PACK6_64 = 24  # base-6 digits per int64 key word (6^24 < 2^62)
MAX_FLAT_WORDS64 = 5  # the flat body covers windows up to 120 symbols
ATTEMPTS = 3  # capacity doublings on overflow
LCP_CHUNK = 1 << 24  # rows per step of the flat body's LCP


class ShardedEbwt(NamedTuple):
    bwt: np.ndarray  # [n] u8 codes (compacted on the host)
    qs: np.ndarray  # [n] u8
    lcp: np.ndarray  # [n] i32
    sa: np.ndarray  # [n] i32 suffix positions in the padded layout
    n: int
    overflow: int  # total bucket overflow of the last attempt (0 == exact)
    attempts: int = 1  # builds run: each overflow retries at doubled capacity


def _spans10(wp: int):
    spans = [PACK]
    while spans[-1] < wp:
        spans.append(spans[-1] * 2)
    return spans


def pad_reads_to_multiple(seqs, quals, lengths, d):
    """Pad the read count to a multiple of d with zero-length rows (pure
    padding: no terminator, sorts last, trimmed from every output)."""
    n_reads = seqs.shape[0]
    if n_reads % d:
        pad = d - n_reads % d
        seqs = np.concatenate([seqs, np.zeros((pad, seqs.shape[1]), seqs.dtype)])
        quals = np.concatenate([quals, np.zeros((pad, seqs.shape[1]), quals.dtype)])
        lengths = np.concatenate([lengths, np.zeros((pad,), lengths.dtype)])
    return seqs, quals, lengths


def _fill(shape, value, dtype, device):
    return torch.full(shape, value, dtype=dtype, device=device)


def _lsd_order(keys: list) -> torch.Tensor:
    """The permutation sorting rows of `keys` (most significant first)
    lexicographically: stable sorts from the last key to the first."""
    perm = None
    for k in reversed(keys):
        _, o = torch.sort(k if perm is None else k[perm], stable=True)
        perm = o if perm is None else perm[o]
    return perm


class Ctx:
    """The collective toolbox bound to one group and its static sizes."""

    def __init__(self, comm: Comm, m: int, n_pad: int, cap_sorted: int,
                 rebalance_cap: int | None = None):
        self.comm, self.d, self.m, self.n_pad, self.cap_sorted = comm, comm.d, m, n_pad, cap_sorted
        self.dev = comm.device
        self.me = comm.shard_id()
        self.base = self.me * m  # global position of this rank's first slot
        self.cap_x = int(2.5 * (cap_sorted // self.d)) + 64  # per-pair exchange capacity
        # rebalance drift per (src, tgt) pair is bounded by the sample-sort
        # imbalance; overflow is reported, never silent
        self.cap_off = rebalance_cap if rebalance_cap is not None else m // 4 + 1024

    def halo_next(self, x, h: int):
        """x[g + h] for local positions (h < m); past n_pad -> -1."""
        nxt = self.comm.from_next_cyclic(x[:h])  # first h of the next rank
        shifted = torch.cat([x[h:], nxt])
        gidx = self.base + torch.arange(self.m, device=self.dev)
        return torch.where(gidx + h < self.n_pad, shifted, -1)

    def shard_offset(self, count):
        """Exclusive prefix over ranks of a per-rank scalar."""
        return self.comm.all_gather(count)[: self.me].sum()

    def prev_valid_halo(self, vals, count):
        """The last valid element of the NEAREST NONEMPTY preceding rank for
        each array in `vals`, and a has-predecessor flag (false on rank 0 and
        when every preceding rank is empty).  A plain neighbour halo would
        read a sentinel across a rank that received nothing."""
        has = self.comm.all_gather(count > 0)  # [d]
        sid = torch.arange(self.d, device=self.dev)
        pidx = torch.where(has & (sid < self.me), sid, -1).max()
        last = torch.clamp_min(count - 1, 0)
        rows = [self.comm.all_gather(v[last])[torch.clamp_min(pidx, 0)] for v in vals]
        return rows, pidx >= 0

    def bucket_exchange(self, payloads, bucket_of, cap: int):
        """Send each element to rank bucket_of (values in [0, d]; d drops
        it); bucket_of must be ascending.  payloads: [(tensor, sentinel)].
        Returns (received [d * cap] per payload, valid mask, overflow, and the
        send layout (src [d, cap], sel [d, cap]))."""
        d, dev = self.d, self.dev
        mm = bucket_of.shape[0]
        ids = torch.arange(d, dtype=bucket_of.dtype, device=dev)
        starts = torch.searchsorted(bucket_of, ids)
        cnt = torch.searchsorted(bucket_of, ids, right=True) - starts
        overflow = torch.clamp_min(cnt - cap, 0).sum()
        cols = torch.arange(cap, device=dev)[None, :]
        src = torch.clamp_max(starts[:, None] + cols, mm - 1)
        sel = cols < torch.clamp_max(cnt, cap)[:, None]
        unsel = ~sel
        recv = [self.comm.a2a(p[src].masked_fill_(unsel, s)).reshape(-1) for p, s in payloads]
        vmask = self.comm.a2a(sel).reshape(-1)
        return recv, vmask, overflow, (src, sel)

    def _fit(self, x, sentinel):
        c = self.cap_sorted
        if x.shape[0] >= c:
            return x[:c]
        return torch.cat([x, _fill((c - x.shape[0],), sentinel, x.dtype, x.device)])

    def dsort(self, key, pos):
        """Distributed sort by int64 key; returns sorted-order buffers (key,
        pos) of cap_sorted slots, the valid count and the overflow."""
        d, m, dev = self.d, self.m, self.dev
        k_s, order = torch.sort(key, stable=True)
        p_s = pos[order]
        step = max(m // d, 1)
        samples = k_s[(torch.arange(d, device=dev) * step).clamp_max(m - 1)]
        alls, _ = torch.sort(self.comm.all_gather(samples).reshape(-1))
        spl = alls[torch.arange(1, d, device=dev) * d]
        bucket = torch.searchsorted(spl, k_s, right=True)
        (rk, rp), vmask, ovf, _ = self.bucket_exchange(
            [(k_s, I64_MAX), (p_s, -1)], bucket, self.cap_sorted // d + 64)
        # local merge; sentinels sort last
        rk = torch.where(vmask, rk, I64_MAX)
        ks, order = torch.sort(rk, stable=True)
        ps = rp[order]
        count = vmask.sum()
        ovf = ovf + torch.clamp_min(count - self.cap_sorted, 0)
        count = torch.clamp_max(count, self.cap_sorted)
        return self._fit(ks, I64_MAX), self._fit(ps, -1), count, ovf

    def dense_rank_to_positions(self, ks, ps, count):
        """Dense-rank the sorted-order keys and route the ranks back to the
        position layout.  Returns (rank [m] int64, overflow)."""
        m, dev = self.m, self.dev
        valid = torch.arange(self.cap_sorted, device=dev) < count
        (prev_last,), has_prev = self.prev_valid_halo([ks], count)
        prev_key = torch.cat([prev_last[None], ks[:-1]])
        changed = (ks != prev_key) & valid
        # no valid predecessor anywhere before this rank -> first key is new
        changed[0] = (~has_prev & valid[0]) | changed[0]
        local_rank = torch.cumsum(changed.to(torch.int64), 0) - 1
        nuniq = torch.clamp_min(local_rank[torch.clamp_min(count - 1, 0)] + 1, 0)
        nuniq = torch.where(count > 0, nuniq, 0)
        dense = local_rank + self.shard_offset(nuniq)
        # route (pos, dense) to rank pos // m, grouped by target
        tgt = torch.where(valid, torch.div(ps, m, rounding_mode="floor"), self.d)
        order = torch.argsort(tgt, stable=True)
        (rpos, rdn), vmask, ovf, _ = self.bucket_exchange(
            [(ps[order], -1), (dense[order], -1)], tgt[order], self.cap_x)
        slot = torch.where(vmask & (rpos >= 0), rpos.to(torch.int64) - self.base, m)
        rank_l = torch.zeros(m + 1, dtype=torch.int64, device=dev)
        rank_l[slot] = torch.where(vmask, rdn, 0)
        return rank_l[:m], ovf

    def global_gather(self, val_l, gidx, sentinel):
        """val[gidx] for global indices gidx (outside [0, n_pad) -> sentinel).
        The answers come back in the layout the requests left in, so the
        caller's own send layout places them."""
        m, d = self.m, self.d
        mm = gidx.shape[0]
        ok = (gidx >= 0) & (gidx < self.n_pad)
        tgt = torch.where(ok, torch.div(gidx, m, rounding_mode="floor"), d)
        order = torch.argsort(tgt, stable=True)
        (rg,), vmask, ovf, (src, sel) = self.bucket_exchange(
            [(gidx[order].to(torch.int64), -1)], tgt[order], self.cap_x)
        vals = val_l[torch.clamp(rg - self.base, 0, m - 1)]
        resp = self.comm.a2a(vals.reshape(d, self.cap_x)).reshape(-1)
        slot = torch.where(sel, order[src], mm).reshape(-1)
        out = _fill((mm + 1,), sentinel, val_l.dtype, self.dev)
        out[slot] = resp
        return torch.where(ok, out[:mm], sentinel), ovf

    def global_scatter(self, vals, gidx, init):
        """Route vals[j] to global position gidx[j]; returns this rank's [m]
        received values (init where nothing lands).  Positions must be
        unique across ranks."""
        m = self.m
        tgt = torch.clamp(torch.div(gidx, m, rounding_mode="floor"), 0, self.d - 1)
        order = torch.argsort(tgt, stable=True)
        (rg, rv), vmask, ovf, _ = self.bucket_exchange(
            [(gidx[order].to(torch.int64), -1), (vals[order], init)], tgt[order], self.cap_x)
        slot = torch.where(vmask & (rg >= 0), rg - self.base, m)
        out = _fill((m + 1,), init, vals.dtype, self.dev)
        out[slot] = rv
        return out[:m], ovf

    def rebalance(self, count, payloads):
        """Exact redistribution of the sorted-order buffers (valid prefix
        `count` of cap_sorted slots, globally contiguous) to the even layout
        where rank s holds global sorted ranks [s*m, (s+1)*m).  Elements
        already on their target rank are placed locally; only the drift
        rides one bucket exchange.  Returns ([m] per payload, overflow)."""
        m, me, dev = self.m, self.me, self.dev
        off = self.shard_offset(count)
        slot_valid = torch.arange(self.cap_sorted, device=dev) < count
        grank = off + torch.arange(self.cap_sorted, device=dev)
        tgt = torch.where(slot_valid, torch.div(grank, m, rounding_mode="floor"), self.d)
        onme = slot_valid & (tgt == me)
        lslot = torch.where(onme, grank - me * m, m)
        # off-diagonal elements, grouped by target (grank is monotone, so the
        # masked-out diagonal keeps the rest grouped after a stable argsort)
        tgt_off = torch.where(slot_valid & ~onme, tgt, self.d)
        order = torch.argsort(tgt_off, stable=True)
        recv, vmask, ovf, _ = self.bucket_exchange(
            [(grank[order], -1)] + [(p[order], init) for p, init in payloads],
            tgt_off[order], self.cap_off)
        rslot = torch.where(vmask & (recv[0] >= 0), recv[0] - me * m, m)
        outs = []
        for (p, init), rv in zip(payloads, recv[1:]):
            out = _fill((m + 1,), init, p.dtype, dev)
            out[lslot] = p
            out[rslot] = rv
            outs.append(out[:m])
        return outs, ovf


def _lcp_flat(prev_rows, kws, has_prev, slot_valid):
    """Leading equal nonzero base-6 digits of each sorted row and the row
    before it (the first row's predecessor is prev_rows, the halo), in
    steps of LCP_CHUNK rows, so that the working arrays stay small beside
    the rows themselves."""
    n = kws[0].shape[0]
    lcp = torch.empty(n, dtype=torch.int32, device=kws[0].device)
    for lo in range(0, n, LCP_CHUNK):
        hi = min(lo + LCP_CHUNK, n)
        if lo == 0:
            a = [torch.cat([p[None], w[: hi - 1]]) for p, w in zip(prev_rows, kws)]
        else:
            a = [w[lo - 1 : hi - 1] for w in kws]
        lcp[lo:hi] = _lcp_rows(a, [w[lo:hi] for w in kws])
    lcp = torch.where(slot_valid, lcp, 0)
    lcp[0] = torch.where(has_prev, lcp[0], 0)
    return lcp


def _lcp_rows(a_words, b_words):
    """The LCP of rows b with predecessor rows a (lists of key words).

    A window's digits are nonzero up to its terminator and zero after it, so
    the count is min(first differing digit, leading nonzero digits of a).
    Each is 24 * (leading words that pass) plus a binary search inside the
    first word that does not (digit prefixes compare as floor divisions by
    powers of 6)."""
    dev = b_words[0].device
    n = b_words[0].shape[0]
    n_words = len(b_words)
    pow6 = torch.tensor([6**e for e in range(PACK6_64 + 1)], dtype=torch.int64, device=dev)
    fw_eq = torch.zeros(n, dtype=torch.int64, device=dev)  # leading equal words
    fw_nz = torch.zeros(n, dtype=torch.int64, device=dev)  # leading all-nonzero words of a
    run_eq = torch.ones(n, dtype=torch.bool, device=dev)
    run_nz = torch.ones(n, dtype=torch.bool, device=dev)
    for a, b in zip(a_words, b_words):
        run_eq &= a == b
        fw_eq += run_eq
        run_nz &= torch.remainder(a, 6) != 0  # all 24 digits nonzero iff the last is
        fw_nz += run_nz
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    a_eq, b_eq, a_nz = zero.expand(n), zero.expand(n), zero.expand(n)
    for w, (a, b) in enumerate(zip(a_words, b_words)):
        a_eq = torch.where(fw_eq == w, a, a_eq)
        b_eq = torch.where(fw_eq == w, b, b_eq)
        a_nz = torch.where(fw_nz == w, a, a_nz)

    def digits(agree):  # leading digits t of the selected word with agree(t, 6^(24-t))
        lo = torch.zeros(n, dtype=torch.int64, device=dev)
        hi = torch.full((n,), PACK6_64, dtype=torch.int64, device=dev)
        for _ in range(PACK6_64.bit_length()):
            mid = (lo + hi) // 2
            ok = agree(mid, pow6[PACK6_64 - mid])
            lo = torch.where(ok, mid, lo)
            hi = torch.where(ok, hi, mid)
        return lo

    def floor(x, p):
        return torch.div(x, p, rounding_mode="floor")

    first_diff = fw_eq * PACK6_64 + torch.where(
        fw_eq < n_words, digits(lambda t, p: floor(a_eq, p) == floor(b_eq, p)), 0)
    # a prefix of t digits is all nonzero iff its last digit is nonzero
    nonzero = fw_nz * PACK6_64 + torch.where(
        fw_nz < n_words,
        digits(lambda t, p: (t == 0) | (torch.remainder(floor(a_nz, p), 6) != 0)), 0)
    return torch.minimum(first_diff, nonzero).to(torch.int32)


def _sort_body(ctx: Ctx, n_reads, width, seqs_l, quals_l, lens_l):
    """Dispatch: the whole-window flat sort for windows of <= 120 symbols,
    prefix doubling beyond."""
    if width + 1 <= PACK6_64 * MAX_FLAT_WORDS64:
        return _sort_body_flat(ctx, n_reads, width, seqs_l, quals_l, lens_l)
    return _sort_body_doubling(ctx, n_reads, width, seqs_l, quals_l, lens_l)


def _text(seqs_l, quals_l, lensl, wp):
    """[m] text symbols (1 + code, 0 at terminator and padding) and qualities."""
    k = torch.arange(wp, device=seqs_l.device)[None, :]
    text = torch.where(k < lensl[:, None],
                       torch.nn.functional.pad(seqs_l.to(torch.uint8), (0, 1)) + 1, 0)
    qtext = torch.nn.functional.pad(quals_l.to(torch.uint8), (0, 1))
    return text.to(torch.uint8).reshape(-1), qtext.reshape(-1)


def _totals(comm: Comm, lensl):
    """The EBWT length n over all ranks: each read's bases plus its
    terminator; a zero-length row is padding."""
    n_valid = comm.psum((lensl > 0).sum())
    return comm.psum(torch.clamp_min(lensl, 0).sum()) + n_valid


def _sort_body_flat(ctx: Ctx, n_reads, width, seqs_l, quals_l, lens_l):
    """ONE distributed multiword sample sort of whole-window packed keys:
    local LSD sort, splitter agreement on whole key ROWS, one bucket
    exchange, local merge.  Position is the last key, so ties resolve in
    global position order (gsufsort's read-index convention)."""
    m, d, cap_sorted, dev = ctx.m, ctx.d, ctx.cap_sorted, ctx.dev
    wp = width + 1
    n_words = -(-wp // PACK6_64)
    lensl = lens_l.to(torch.int64)
    k = torch.arange(wp, device=dev)[None, :]
    is_pad = ((k > lensl[:, None]) | (lensl[:, None] <= 0)).reshape(-1)

    # ---- whole-window base-6 keys; padding suffixes sort after every real
    # window (a real word 0 is < 6^24) ----
    words = _pack_words(seqs_l, lensl, wp, n_words)
    words[0] = torch.where(is_pad, 6**PACK6_64, words[0])

    # ---- payload: (prev symbol, prev quality, prev^2 symbol), the first
    # ones from a cyclic halo of the previous rank ----
    text_l, qtext_l = _text(seqs_l, quals_l, lensl, wp)
    tail2 = ctx.comm.from_prev_cyclic(text_l[m - 2:])
    qtail = ctx.comm.from_prev_cyclic(qtext_l[m - 1:])
    p1 = torch.cat([tail2[1:], text_l[:-1]]).to(torch.int32)
    p2 = torch.cat([tail2, text_l[:-2]]).to(torch.int32)
    q1 = torch.cat([qtail, qtext_l[:-1]]).to(torch.int32)
    aux = p1 | (q1 << 3) | (p2 << 11)
    pos = ctx.base + torch.arange(m, dtype=torch.int32, device=dev)

    # ---- local sort of (words..., pos) rows: pos ascending already, so the
    # LSD passes need only the words ----
    perm = _lsd_order(words)
    kw = [w[perm] for w in words]
    ps, ax = pos[perm], aux[perm]
    del words, perm, aux

    # ---- splitter ROWS: all words and pos, jointly sorted ----
    step = max(m // d, 1)
    sample_idx = (torch.arange(d, device=dev) * step).clamp_max(m - 1)
    samples = [ctx.comm.all_gather(w[sample_idx]).reshape(-1) for w in kw + [ps]]
    order = _lsd_order(samples)
    spl_idx = torch.arange(1, d, device=dev) * d
    spl = [s[order][spl_idx] for s in samples]  # [d - 1] per key

    bucket = torch.zeros(m, dtype=torch.int64, device=dev)
    for s in range(d - 1):
        gt = torch.zeros(m, dtype=torch.bool, device=dev)
        eq = torch.ones(m, dtype=torch.bool, device=dev)
        for w in range(n_words):
            gt |= eq & (kw[w] > spl[w][s])
            eq &= kw[w] == spl[w][s]
        gt |= eq & (ps > spl[n_words][s])
        bucket += gt

    payloads = [(w, I64_MAX) for w in kw] + [(ps, -1), (ax, 0)]
    del kw, ps, ax
    recv, vmask, overflow, _ = ctx.bucket_exchange(payloads, bucket, cap_sorted // d + 64)
    del payloads, bucket
    # sentinel keys on invalid lanes, in place: ties exist only among them
    # (all-sentinel keys), and their order is never read past count
    invalid = ~vmask
    for r in recv[:n_words]:
        r.masked_fill_(invalid, I64_MAX)
    recv[n_words].masked_fill_(invalid, I32_MAX)
    del invalid
    perm = _lsd_order(recv[: n_words + 1])
    # each received array is permuted and released in turn
    kws = []
    for i in range(n_words):
        kws.append(ctx._fit(recv[i][perm], I64_MAX))
        recv[i] = None
    sa = ctx._fit(recv[n_words][perm], -1)
    axs = ctx._fit(recv[n_words + 1][perm], 0)
    del recv, perm
    count = vmask.sum()
    overflow = overflow + torch.clamp_min(count - cap_sorted, 0)
    count = torch.clamp_max(count, cap_sorted)
    slot_valid = torch.arange(cap_sorted, device=dev) < count

    # ---- BWT / QS / predecessor from the payload ----
    cprev = (axs & 7).to(torch.uint8)
    is_term = cprev == 0
    bwt_s = torch.where(is_term, alphabet.TERM, cprev - 1).to(torch.uint8)
    qs_s = torch.where(is_term, alphabet.TERM_CHAR, (axs >> 3) & 0xFF).to(torch.uint8)
    c2 = ((axs >> 11) & 7).to(torch.uint8)
    pre_s = torch.where(c2 == 0, alphabet.TERM, c2 - 1).to(torch.uint8)
    bwt_s = torch.where(slot_valid, bwt_s, alphabet.SIGMA).to(torch.uint8)
    qs_s = torch.where(slot_valid, qs_s, 0).to(torch.uint8)

    # ---- LCP against the last row of the nearest nonempty preceding rank ----
    prev_rows, has_prev = ctx.prev_valid_halo(kws, count)
    lcp_s = _lcp_flat(prev_rows, kws, has_prev, slot_valid)

    n = _totals(ctx.comm, lensl)
    overflow = ctx.comm.psum(overflow)
    return SimpleNamespace(bwt=bwt_s, qs=qs_s, lcp=lcp_s, sa=sa, count=count,
                           text=text_l, qtext=qtext_l, n=n, overflow=overflow, pre=pre_s)


def _sort_body_doubling(ctx: Ctx, n_reads, width, seqs_l, quals_l, lens_l):
    """Distributed prefix doubling: round 0 sorts span-10 words with a
    read-index tie-break, each round doubles the span with a halo of the
    ranks, and the LCP lifts over the kept ranks through routed gathers."""
    m, n_pad, cap_sorted, dev = ctx.m, ctx.n_pad, ctx.cap_sorted, ctx.dev
    wp = width + 1
    nl = m // wp  # reads per rank
    spans = _spans10(wp)
    lensl = lens_l.to(torch.int64)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)

    w0 = _pack_word(_window_codes(seqs_l, lensl), wp, 0).to(torch.int64)  # span-10 word
    k = torch.arange(wp, device=dev)[None, :]
    rid = ctx.me * nl + torch.arange(nl, device=dev)[:, None]
    # zero-length rows are divisibility padding: every position is pad
    is_pad = (k > lensl[:, None]) | (lensl[:, None] <= 0)
    term_near = (lensl[:, None] - k >= 0) & (lensl[:, None] - k < PACK)
    g_local = ctx.base + torch.arange(m, device=dev)
    tb = torch.where(is_pad, n_reads + 1 + g_local.reshape(nl, wp),
                     torch.where(term_near, rid + 1, 0)).reshape(-1)
    w0m = torch.where(is_pad.reshape(-1), 2**30, w0)
    pos = g_local.to(torch.int32)

    ks, ps, count, ovf = ctx.dsort((w0m << 32) | tb, pos)
    overflow += ovf
    rank_l, ovf = ctx.dense_rank_to_positions(ks, ps, count)
    overflow += ovf
    del tb, w0m, is_pad, term_near

    ranks = [rank_l]
    for i, h in enumerate(spans[:-1]):
        ra = ctx.halo_next(rank_l, h)
        ks, ps, count, ovf = ctx.dsort((rank_l << 31) | (ra + 2), pos)
        overflow += ovf
        if i + 1 < len(spans) - 1:
            rank_l, ovf = ctx.dense_rank_to_positions(ks, ps, count)
            overflow += ovf
            ranks.append(rank_l)
    del ks

    # ---- BWT / QS in sorted order; invalid slots request nothing ----
    text_l, qtext_l = _text(seqs_l, quals_l, lensl, wp)
    sa = ps
    slot_valid = torch.arange(cap_sorted, device=dev) < count
    prev = torch.where(slot_valid, torch.remainder(sa.to(torch.int64) - 1, n_pad), -1)
    tq = text_l.to(torch.int32) | (qtext_l.to(torch.int32) << 8)
    tq_prev, ovf = ctx.global_gather(tq, prev, 0)
    overflow += ovf
    cprev = (tq_prev & 0xFF).to(torch.uint8)
    is_term = cprev == 0
    bwt_s = torch.where(is_term, alphabet.TERM, cprev - 1).to(torch.uint8)
    qs_s = torch.where(is_term, alphabet.TERM_CHAR, tq_prev >> 8).to(torch.uint8)

    # ---- LCP by lifting over the ranks, from the nearest nonempty
    # preceding rank's last suffix ----
    (prev_sa,), has_prev = ctx.prev_valid_halo([sa], count)
    far = -(2**40)  # keeps a + h negative for any offset h
    first = torch.arange(cap_sorted, device=dev) == 0
    a = torch.where(slot_valid, torch.cat([prev_sa[None], sa[:-1]]).to(torch.int64), far)
    a = torch.where(first & ~has_prev, far, a)
    b = torch.where(slot_valid, sa.to(torch.int64), far)
    h = torch.zeros(cap_sorted, dtype=torch.int64, device=dev)
    for span, r in zip(reversed(spans[:-1]), reversed(ranks)):
        va, ovf_a = ctx.global_gather(r, a + h, -1)
        vb, ovf_b = ctx.global_gather(r, b + h, -2)
        overflow += ovf_a + ovf_b
        h = torch.where((va == vb) & (va >= 0), h + span, h)
    del ranks
    # the remainder (< PACK symbols) from the packed words
    pa, ovf_a = ctx.global_gather(w0, a + h, -1)
    pb, ovf_b = ctx.global_gather(w0, b + h, -2)
    overflow += ovf_a + ovf_b
    rem = torch.zeros(cap_sorted, dtype=torch.int64, device=dev)
    nz = torch.ones(cap_sorted, dtype=torch.bool, device=dev)
    eq = torch.ones(cap_sorted, dtype=torch.bool, device=dev)
    for j in range(1, PACK + 1):
        sh = 3 * (PACK - j)
        eq &= (pa >> sh) == (pb >> sh)
        nz &= ((pa >> sh) & 7) != 0
        rem += eq & nz
    lcp_s = (h + rem).to(torch.int32)
    lcp_s = torch.where(first & ~has_prev, 0, lcp_s)

    n = _totals(ctx.comm, lensl)
    overflow = ctx.comm.psum(overflow)
    return SimpleNamespace(bwt=bwt_s, qs=qs_s, lcp=lcp_s, sa=sa, count=count,
                           text=text_l, qtext=qtext_l, n=n, overflow=overflow, pre=None)


def local_rows(arrays, comm: Comm):
    """This rank's contiguous share of each host array (equal shares)."""
    rows = arrays[0].shape[0] // comm.d
    return [torch.as_tensor(np.ascontiguousarray(a[comm.rank * rows:(comm.rank + 1) * rows]))
            .to(comm.device) for a in arrays]


def build_ebwt_sharded(seqs, quals, lengths, comm: Comm, capacity_factor: float = 2.5) -> ShardedEbwt:
    """The global EBWT of the collection, built with the reads split over
    the ranks of `comm`; every rank passes the whole host batch and gets
    the whole result.  Read counts not divisible by the rank count are
    padded with zero-length rows.  Bucket overflow retries with doubled
    capacity (ATTEMPTS in all)."""
    d = comm.d
    seqs, quals, lengths = pad_reads_to_multiple(seqs, quals, lengths, d)
    n_reads, width = seqs.shape
    n_pad = n_reads * (width + 1)
    m = n_pad // d
    seqs_l, quals_l, lens_l = local_rows((seqs, quals, lengths.astype(np.int32)), comm)
    for attempt in range(1, ATTEMPTS + 1):
        cap_sorted = int(capacity_factor * m) + 64
        r = _sort_body(Ctx(comm, m, n_pad, cap_sorted), n_reads, width, seqs_l, quals_l, lens_l)
        overflow = int(r.overflow)
        if overflow == 0:
            break
        capacity_factor *= 2  # retry with more headroom (the last result is kept)

    counts = comm.all_gather(r.count).cpu().numpy()
    bufs = [comm.all_gather(x).cpu().numpy() for x in (r.bwt, r.qs, r.lcp, r.sa)]
    bwt, qs, lcp, sa = (np.concatenate([b[i, : counts[i]] for i in range(d)]) for b in bufs)
    # padding suffixes sort last globally; the EBWT is the first n entries
    n = int(r.n)
    lcp = lcp.astype(np.int32)[:n]
    lcp[0] = 0
    return ShardedEbwt(bwt=bwt[:n], qs=qs[:n], lcp=lcp, sa=sa.astype(np.int32)[:n],
                       n=n, overflow=overflow, attempts=attempt)

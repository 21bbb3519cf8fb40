"""The plain reference of BFQzip's smoothing: EBWT, LCP, clusters, inversion.

Plain PyTorch, written from the reference tool's semantics (gsufsort's
extended BWT of a read collection, bfq_int.cpp's positional clusters and
their smoothing rules, the LF inversion) and from nothing of the program
under test: it imports no module of it, and takes only the reads.  Every
function runs on the device of its input tensors, so the check can run it on
the card once the program's state is freed.

Conventions (the reference tool's):

* The text is s_0 $_0 s_1 $_1 ... with pairwise-distinct end markers,
  $_i < $_j iff i < j, all below every base; bases collate # < A < C < G <
  N < T (codes 0..5).
* Suffixes are sorted by prefix doubling over dense ranks; two suffixes'
  LCP is found by binary lifting over the ranks kept at each doubling level
  (end markers are distinct, so they never match).
* BWT[j] is the symbol before suffix SA[j], its quality travels with it
  ('#' at end markers), pre[j] the symbol before that.
* Clusters are the maximal runs of (LCP >= K) and not an LCP minimum,
  widened by one position to the left, of at least `min_cluster`
  positions; each is decided and smoothed as bfq_int.cpp does.
* Inversion puts every smoothed BWT symbol and quality back at the text
  position it came from.
"""

from __future__ import annotations

import torch

TERM, A, C, G, N, T = 0, 1, 2, 3, 4, 5
TERM_QUAL = ord("#")
DECODE = b"#ACGNT"
# the tool's frequency order A, C, G, T, N: code -> order (-1 for TERM), order -> code
_ORD_OF_CODE = (-1, 0, 1, 2, 4, 3)
_CODE_OF_ORD = (A, C, G, T, N)
_N_ORD = 4
STATS = ("num_clust", "num_clust_discarded", "num_clust_amb_discarded", "num_clust_mod",
         "num_clust_alleq", "bases_inside", "qs_smoothed", "modified")


BLOCK = 1 << 26  # positions per block of the per-position passes


def _blocks(n: int):
    for lo in range(0, n, BLOCK):
        yield lo, min(lo + BLOCK, n)


def text_of(seqs: torch.Tensor, quals: torch.Tensor, lengths: torch.Tensor) -> dict:
    """The concatenated text of a padded [N, W] read batch.

    Returns `text` (int32: read i's end marker is i, base code c is N + c),
    `qual` (uint8, '#' at end markers) and `starts` (int64 [N], where each
    read begins in the text)."""
    n_reads, width = seqs.shape
    dev = seqs.device
    lens = lengths.to(torch.int64)
    col = torch.arange(width + 1, device=dev)
    real = col[None, :] <= lens[:, None]  # bases and the end marker
    is_base = col[None, :] < lens[:, None]
    rows = torch.arange(n_reads, device=dev, dtype=torch.int32)[:, None]
    wide = torch.zeros((n_reads, width + 1), dtype=torch.int32, device=dev)
    wide[:, :width] = seqs.to(torch.int32) + n_reads
    text = torch.where(is_base, wide, rows.expand(-1, width + 1))[real]
    del wide
    qwide = torch.full((n_reads, width + 1), TERM_QUAL, dtype=torch.uint8, device=dev)
    qwide[:, :width] = quals
    qual = torch.where(is_base, qwide, TERM_QUAL)[real]
    del qwide
    starts = torch.cumsum(lens + 1, 0) - (lens + 1)
    return {"text": text, "qual": qual, "starts": starts, "n_reads": n_reads}


def suffix_array(text: torch.Tensor, n_reads: int) -> tuple:
    """(SA, levels): SA (int64) by prefix doubling of the int32 text; levels
    is [(h, rank)] with rank (int32; the text itself at h = 1) equal at two
    positions iff their h-prefixes are equal, for every h below the level
    at which all ranks became distinct."""
    n = text.numel()
    dev = text.device
    levels = [(1, text)]
    mult = max(n, n_reads + 6) + 2
    h = 1
    while True:
        rank = levels[-1][1]
        key = torch.full((n,), 0, dtype=torch.int64, device=dev)
        key[: max(n - h, 0)] = rank[h:].to(torch.int64) + 1
        key += rank.to(torch.int64) * mult
        skey, order = torch.sort(key)
        del key
        step = torch.zeros(n, dtype=torch.int32, device=dev)
        step[1:] = (skey[1:] != skey[:-1]).to(torch.int32)
        del skey
        dense = torch.cumsum(step, 0, dtype=torch.int32)
        del step
        distinct = int(dense[-1]) + 1 if n else 0
        h *= 2
        if distinct == n:
            return order, levels
        new = torch.empty(n, dtype=torch.int32, device=dev)
        new[order] = dense
        del dense, order
        levels.append((h, new))


def lcp_of(sa: torch.Tensor, levels: list) -> torch.Tensor:
    """lcp[j] = LCP of suffixes SA[j-1] and SA[j] (int32); lcp[0] = 0."""
    n = sa.numel()
    lcp = torch.zeros(n, dtype=torch.int32, device=sa.device)
    for lo, hi in _blocks(n - 1):
        a, b = sa[lo:hi], sa[lo + 1:hi + 1]
        run = torch.zeros(hi - lo, dtype=torch.int64, device=sa.device)
        for h, rank in reversed(levels):
            ia, ib = a + run, b + run
            same = (ia < n) & (ib < n)
            same &= rank[ia.clamp_(max=n - 1)] == rank[ib.clamp_(max=n - 1)]
            run += h * same
        lcp[lo + 1:hi + 1] = run
    return lcp


def ebwt(seqs: torch.Tensor, quals: torch.Tensor, lengths: torch.Tensor) -> dict:
    """The EBWT of the batch: bwt (uint8 codes), qs (uint8), lcp (int32),
    pre (uint8 codes, the symbol before each BWT symbol), and `dest`, the
    [N, W] flat index each BWT symbol came from (-1 for end markers)."""
    t = text_of(seqs, quals, lengths)
    n_reads = t["n_reads"]
    sa, levels = suffix_array(t["text"], n_reads)
    lcp = lcp_of(sa, levels)
    del levels
    text = t["text"]
    n = text.numel()
    src = torch.remainder(sa - 1, n)
    before = text[torch.remainder(sa - 2, n)]
    del sa
    pre = torch.where(before < n_reads, 0, before - n_reads).to(torch.uint8)
    del before
    sym = text[src]
    bwt = torch.where(sym < n_reads, 0, sym - n_reads).to(torch.uint8)
    del sym, text, t["text"]
    qs = t["qual"][src]
    del t["qual"]
    # where each BWT symbol sits in the [N, W] batch: row * W + column
    width = seqs.shape[1]
    starts, lens = t["starts"], lengths.to(torch.int64)
    dest = torch.empty(n, dtype=torch.int64, device=src.device)
    for lo, hi in _blocks(n):
        p = src[lo:hi]
        row = torch.searchsorted(starts, p, right=True) - 1
        col = p - starts[row]
        dest[lo:hi] = torch.where(col < lens[row], row * width + col, -1)
    return {"bwt": bwt, "qs": qs, "lcp": lcp, "pre": pre, "dest": dest, "n_reads": n_reads}


def _clusters(lcp: torch.Tensor, k: int, min_cluster: int) -> tuple:
    """(cid, count): the cluster index (int32) of every BWT position, -1 outside."""
    n = lcp.numel()
    dev = lcp.device
    pred = lcp >= k
    if n >= 3:
        mid = lcp[1:-1]
        pred[1:-1] &= ~((mid < lcp[:-2]) & (lcp[2:] >= mid))  # not an LCP minimum
    prev = torch.zeros_like(pred)
    prev[1:] = pred[:-1]
    start_mark = pred & ~prev
    prev[:-1] = pred[1:]
    prev[-1] = False
    starts = torch.nonzero(start_mark).squeeze(1)
    ends = torch.nonzero(pred & ~prev).squeeze(1)
    del prev
    cid = torch.full((n,), -1, dtype=torch.int32, device=dev)
    if starts.numel() == 0:
        return cid, 0
    # a cluster is [run start - 1, run end]: lcp[0] = 0, so a run never starts at 0
    keep = ends - starts + 2 >= min_cluster
    run_cluster = (torch.cumsum(keep.to(torch.int32), 0, dtype=torch.int32) - 1)
    run_cluster = torch.where(keep, run_cluster, -1)
    run_of = torch.cumsum(start_mark.to(torch.int32), 0, dtype=torch.int32) - 1
    del start_mark
    cid = torch.where(pred, run_cluster[run_of.clamp_(min=0).to(torch.int64)], cid)
    del run_of, pred
    cid[starts[keep] - 1] = run_cluster[keep]
    return cid, int(keep.sum())


def smooth(bwt: torch.Tensor, qs: torch.Tensor, lcp: torch.Tensor, pre: torch.Tensor,
           cfg: dict) -> tuple:
    """(bwt_sub, qs_new, stats) of bfq_int.cpp's cluster smoothing, for the
    smoothing fields of a configuration (k, min_cluster, mode, default_qs,
    quality_threshold, freq_threshold, border).  Per-cluster totals are
    gathered, and the changes applied, in blocks of positions."""
    if cfg["border"] != 1:
        raise ValueError("the reference smooths with border 1 only")
    dev = bwt.device
    n = bwt.numel()
    m = cfg["min_cluster"]
    qt = cfg["quality_threshold"] + 33
    cid, count = _clusters(lcp, cfg["k"], m)
    ord_of = torch.tensor(_ORD_OF_CODE, dtype=torch.int64, device=dev)
    code_of = torch.tensor(_CODE_OF_ORD, dtype=torch.uint8, device=dev)

    def block(lo, hi):
        """(positions, cluster, order, quality) of the block's in-cluster bases."""
        o = ord_of[bwt[lo:hi].to(torch.int64)]
        c = cid[lo:hi].to(torch.int64)
        pos = torch.nonzero((c >= 0) & (o >= 0)).squeeze(1)
        return pos + lo, c[pos], o[pos], qs[lo:hi][pos].to(torch.int64)

    freq = torch.zeros(5 * count, dtype=torch.int64, device=dev)
    trusted = torch.zeros(5 * count, dtype=torch.int64, device=dev)
    qmax = torch.zeros(count, dtype=torch.int64, device=dev)
    qsum = torch.zeros(count, dtype=torch.int64, device=dev)
    esum = torch.zeros(count, dtype=torch.float64, device=dev)
    for lo, hi in _blocks(n):
        _, c, o, q = block(lo, hi)
        freq += torch.bincount(c * 5 + o, minlength=5 * count)
        sel = q >= qt
        trusted += torch.bincount(c[sel] * 5 + o[sel], minlength=5 * count)
        if cfg["mode"] == 0:
            qmax.scatter_reduce_(0, c, q, reduce="amax")
        elif cfg["mode"] == 3:
            qsum.index_add_(0, c, q)
        elif cfg["mode"] == 1:
            esum.index_add_(0, c, torch.pow(10.0, -(q.to(torch.float64) - 33.0) / 10.0))
    freq = freq.reshape(count, 5)
    low_qs = (trusted > 0).reshape(count, 5)
    del trusted
    base_num = freq.sum(1)
    # each cluster's replacement quality (raw ASCII), bfq_int.cpp's M
    if cfg["mode"] == 2:
        newqs = torch.full((count,), cfg["default_qs"], dtype=torch.int64, device=dev)
    elif cfg["mode"] == 0:
        newqs = qmax
    elif cfg["mode"] == 3:
        newqs = torch.div(qsum, base_num.clamp(min=1), rounding_mode="floor")
    else:  # mean error probability in float64, rounded half to even
        mean = esum / base_num.clamp(min=1).to(torch.float64)
        newqs = torch.round(-10.0 * torch.log10(mean)).to(torch.int64) + 33
    del qmax, qsum, esum

    has = base_num > 0
    nnn = (freq > 0).sum(1)
    perc = torch.div(100 * freq, base_num.clamp(min=1)[:, None], rounding_mode="floor")
    isfreq = (perc >= cfg["freq_threshold"]) & (freq > 0)
    del perc
    nfreq = isfreq.sum(1)
    order = torch.arange(5, device=dev).expand(count, 5)
    f0 = torch.where(isfreq, order, 5).min(1).values
    f1 = torch.where(isfreq & (order > f0[:, None]), order, 5).min(1).values
    del isfreq

    disc = has & ((nfreq == 0) | ((nfreq == 1) & (f0 == _N_ORD)) | ((nfreq == 2) & (base_num < m)))
    single = has & (nfreq == 1) & (f0 != _N_ORD)
    two = has & (nfreq == 2) & (base_num >= m)
    two_n = two & (f1 == _N_ORD)
    two_b = two & (f1 != _N_ORD)
    target = torch.where(single | two_n, f0, -1)

    # the SNP rule: the distinct non-N symbols before each frequent symbol
    seen = torch.zeros(count * 8, dtype=torch.int64, device=dev)
    for lo, hi in _blocks(n):
        pos, c, o, _ = block(lo, hi)
        p = ord_of[pre[pos].to(torch.int64)]
        base_pre = (p >= 0) & (p < _N_ORD)
        for t, ft in enumerate((f0, f1)):
            sel = (o == ft[c]) & base_pre
            seen += torch.bincount((c[sel] * 2 + t) * 4 + p[sel], minlength=8 * count)
    seen = seen.reshape(count, 2, 4) > 0
    one_each = seen.sum(2) == 1
    prec = torch.where(seen, torch.arange(4, device=dev), 4).min(2).values
    two_ok = two_b & one_each[:, 0] & one_each[:, 1] & (prec[:, 0] != prec[:, 1])
    del seen

    stats = {
        "num_clust": count,
        "num_clust_discarded": int(disc.sum()),
        "num_clust_amb_discarded": int((two_b & ~two_ok).sum()),
        "num_clust_mod": int((two_n | two_ok).sum()),
        "num_clust_alleq": int((has & (nnn == 1)).sum()),
        "bases_inside": int(base_num.sum()),
        "modified": 0,
        "qs_smoothed": 0,
    }

    bwt_sub = bwt.clone()
    qs_new = qs.clone()
    for lo, hi in _blocks(n):
        pos, c, o, q = block(lo, hi)
        p = ord_of[pre[pos].to(torch.int64)]
        nq = newqs[c]
        low = low_qs[c, o]
        tgt = target[c]
        ok2 = two_ok[c]
        g0, g1 = f0[c], f1[c]
        is_freq_sym = ((o == g0) | (o == g1)) & ok2
        # a single frequent symbol (or one beside N)
        s_sub = (tgt >= 0) & (o != tgt) & ~low
        s_set = (tgt >= 0) & (o == tgt)
        s_low = (tgt >= 0) & (o != tgt) & low & (nq < q)
        # two symbols with distinct single predecessors
        other = ok2 & ~is_freq_sym
        d_sub0 = other & ~low & (p == prec[c, 0])
        d_sub1 = other & ~low & (p == prec[c, 1]) & ~d_sub0
        d_low = other & low & (nq < q)
        sub_ord = torch.where(s_sub, tgt, torch.where(d_sub0, g0, g1))
        substitute = s_sub | d_sub0 | d_sub1
        requal = s_set | s_low | is_freq_sym | d_low
        bwt_sub[pos[substitute]] = code_of[sub_ord[substitute]]
        qs_new[pos[requal]] = nq[requal].to(torch.uint8)
        stats["modified"] += int(substitute.sum())
        stats["qs_smoothed"] += int(requal.sum())
    return bwt_sub, qs_new, stats


def illumina_8_level(q: torch.Tensor) -> torch.Tensor:
    """Illumina's 8-level binning of raw ASCII qualities (bfq_int.cpp:307-319)."""
    p = q.to(torch.int64) - 33
    out = p.clone()
    for lo, level in ((2, 6), (10, 15), (20, 22), (25, 27), (30, 33), (35, 37), (40, 40)):
        out = torch.where(p >= lo, level, out)
    return (out + 33).to(torch.uint8)


def invert(e: dict, bwt_sub: torch.Tensor, qs_new: torch.Tensor, shape: tuple,
           binning: bool) -> tuple:
    """(seqs, quals) [N, W]: each smoothed symbol back where it came from."""
    real = e["dest"] >= 0
    where = e["dest"][real]
    seqs = torch.zeros(shape, dtype=torch.uint8, device=bwt_sub.device)
    quals = torch.zeros(shape, dtype=torch.uint8, device=bwt_sub.device)
    seqs.view(-1)[where] = bwt_sub[real]
    q = qs_new[real]
    quals.view(-1)[where] = illumina_8_level(q) if binning else q
    return seqs, quals


def smooth_reads(seqs: torch.Tensor, quals: torch.Tensor, lengths: torch.Tensor, cfg: dict,
                 artifacts: bool = False) -> dict:
    """The whole reference: smoothed seqs and quals ([N, W], zero past each
    read), the stats, and with `artifacts` the step-1 arrays bwt, qs, lcp."""
    e = ebwt(seqs, quals, lengths)
    bwt_sub, qs_new, stats = smooth(e["bwt"], e["qs"], e["lcp"], e["pre"], cfg)
    del e["pre"]
    out_s, out_q = invert(e, bwt_sub, qs_new, tuple(seqs.shape), cfg["binning"])
    out = {"seqs": out_s, "quals": out_q, "stats": stats}
    if artifacts:
        out.update(bwt=e["bwt"], qs=e["qs"], lcp=e["lcp"])
    return out


def fastq_bytes(seqs, quals, lengths) -> bytes:
    """FASTQ records with bare '@' header lines, as numpy arrays or tensors."""
    import numpy as np

    seqs, quals, lengths = (x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
                            for x in (seqs, quals, lengths))
    n, width = seqs.shape
    lens = lengths.astype(np.int64)
    table = np.frombuffer(DECODE, dtype=np.uint8)
    rec = 2 + (lens + 1) + 2 + (lens + 1)
    start = np.concatenate(([0], np.cumsum(rec)[:-1]))
    buf = np.full(int(rec.sum()), ord("\n"), dtype=np.uint8)
    buf[start] = ord("@")
    col = np.arange(width)
    inside = col[None, :] < lens[:, None]
    seq_at = (start + 2)[:, None] + col[None, :]
    buf[seq_at[inside]] = table[seqs[inside]]
    buf[start + 2 + lens + 1] = ord("+")
    q_at = (start + 2 + lens + 3)[:, None] + col[None, :]
    buf[q_at[inside]] = quals[inside]
    return buf.tobytes()

"""Out-of-core pipeline: datasets larger than device memory.

Port of bfqzip_tpu/external.py (see its docstring for the design): device
memory is bounded by a budget, the full arrays stay on the host (in spill
files when they are large), and the output is the in-core engine's whenever
every read is shorter than 255 bp.

  1. chunked stage 1: each read chunk's suffixes are sorted on the device
     (ops/suffix.build_ebwt, flat or doubling by read width); only the
     chunk's suffix positions and 255-capped LCPs come back to the host;
  2. the k-way merge (the port's csrc/extmerge.cpp through
     utils/native.ext_merge_async) interleaves the chunk orders into the
     global BWT, QS, 1-byte LCP, smoothing predecessor and SA on host
     threads, while stage 3 smooths the merged prefix (BFQ_EXT_OVERLAP=0:
     the merge ends before smoothing starts);
  3. streaming cluster smoothing: ops/smooth.cluster_words runs per device
     segment through SeqChunkOps, whose every scan takes the previous
     segment's boundary value as the CUDA kernel's per-channel init, so the
     carries stay on the device; clusters that close inside the segment plus
     its halo are applied in the forward pass, the rest by the small phase-B
     fix-ups (_fix_tail, _apply_segment);
  4. inversion is the host scatter grid[(SA-1) mod n_pad], per segment,
     its targets sorted on the device so that the host writes in order.

Differences from the JAX package, none of which changes a byte:
  - the merge is the port's own copy, whose live prefix never shows a range
    seam before its boundary LCP is fixed and grows at the whole thread
    pool's rate (ordered ranges, more than the threads); an error in the
    overlapped merge raises in the caller, and a stage that raises while
    the merge runs joins it before the spill files close;
  - the last chunk is sorted at its own size (no compile shape to pad to);
  - a chunk's outputs are copied to the host before the next chunk sorts,
    so the device holds one chunk;
  - the coordinate dtype is a tensor dtype (int64 beyond 2^31 positions or
    with BFQ_EXT_SA64=1), with no global switch;
  - a spill directory this function created is closed if a stage raises;
  - each segment's scatter takes its (target, output) pairs sorted by
    target on the device, so the host writes its array in order (in SA
    order the writes land at random, several times slower and swinging
    with the host's memory load).

Spans (utils/profiling.span, recorded only while tracing): the call
`external.smooth_fastq` > `external.pack_text`, one `external.sort_chunk` a
chunk (the device sort, its copies to the host and their store into the
host arrays), `external.merge_wait` each time smoothing blocks on the merge,
one `external.segment` a segment (uploads, the forward pass, the sort of
its scatter targets and the download of its packed output), one
`external.scatter` a segment (the host scatter that inverts it), `external.phase_b` and `external.emit`.  The report's
`spill` says whether the host arrays went to spill files (a short scratch
disk falls back to RAM) and `spill_bytes` how many bytes of spill files the
call made.
"""

from __future__ import annotations

import contextlib
import logging
import math
import os
import resource
import shutil
import time
from typing import Tuple

import numpy as np
import torch

from bfqzip_tpu_torch import alphabet
from bfqzip_tpu_torch.config import SmoothConfig
from bfqzip_tpu_torch.io.fastq import ReadBatch, fastq_array, write_fastq
from bfqzip_tpu_torch.io.spill import Spill
from bfqzip_tpu_torch.utils import native
from bfqzip_tpu_torch.ops.invert import illumina_bin
from bfqzip_tpu_torch.ops.scan import LOCAL_OPS, LocalScanOps
from bfqzip_tpu_torch.ops.smooth import apply_words, cluster_words
from bfqzip_tpu_torch.ops.suffix import PACK6, _spans, build_ebwt, build_route
from bfqzip_tpu_torch.utils.profiling import resolve_device, span

_LOG = logging.getLogger("bfqzip.external")

# device bytes per position of one smoothing segment with its uploads and
# packed output: the peaks measured with torch.cuda.max_memory_allocated on
# an NVIDIA H100 80GB HBM3 (PERF.md), 189 with int32 coordinates and 201
# with int64, plus ~5%
_SMOOTH_BYTES_PER_POS = 210


def _build_bytes_per_pos(width: int) -> int:
    """Device bytes per suffix position of one chunk sort (_sort_chunk: its
    input, build and 255-capped LCP), plus 5%.  The flat build keeps
    ceil((width + 1) / 24) int64 key words live, twice over in its LCP pass;
    the doubling build keeps one int32 rank per round.  The fit is within
    1 B/pos of the peaks measured on an NVIDIA H100 80GB HBM3 (PERF.md) at
    101-323 bp (flat, 191-303) and 330-2000 bp (doubling, 92-104)."""
    wp = width + 1
    if build_route(width) == "flat":
        words = -(-wp // PACK6)
        per_pos = max(152 + 8 * words, 79 + 16 * words)
    else:
        per_pos = 73 + 4 * len(_spans(wp))
    return math.ceil(per_pos * 1.05)


class SeqChunkOps(LocalScanOps):
    """ops/scan.LocalScanOps for ONE segment of a longer array.

    Arrays passed in are [seg_len + halo] (halo = right lookahead; the caller
    discards the output tail).  Left-to-right ops take the carry recorded by
    the same call (by order) on the previous segment as their init, and
    record their value at the true boundary seg_len-1 for the next one.
    Carries are device tensors: no value goes to the host.
    """

    def __init__(self, base: torch.Tensor, seg_len: int, carries_in, scans: LocalScanOps = LOCAL_OPS):
        self.base = base  # 0-d tensor: global position of local slot 0
        self.seg_len = seg_len
        self.carries_in = carries_in  # list, or None on the first segment
        self.carries_out = []
        self.scans = scans  # runs every scan: the kernel on CUDA tensors
        self._i = 0

    def _scan(self, x, flag, op: str, init, reverse: bool = False) -> torch.Tensor:
        return self.scans._scan(x, flag, op, init, reverse)

    def _carry(self, default):
        i = self._i
        self._i += 1
        return default if self.carries_in is None else self.carries_in[i]

    def _record(self, value: torch.Tensor):
        # a copy: a view would keep the whole [seg_len + halo] array alive
        self.carries_out.append(value.clone())

    def iota(self, n: int, device) -> torch.Tensor:
        return self.base + torch.arange(n, dtype=self.base.dtype, device=device)

    def shift_prev(self, x: torch.Tensor, fill) -> torch.Tensor:
        carry = self._carry(torch.full((), fill, dtype=x.dtype, device=x.device))
        self._record(x[self.seg_len - 1])
        return torch.cat([carry.reshape(1), x[:-1]])

    def cummax(self, x: torch.Tensor) -> torch.Tensor:
        carry = self._carry(torch.iinfo(x.dtype).min)
        flag = torch.zeros(x.shape[-1], dtype=torch.bool, device=x.device)
        out = self._scan(x, flag, "max", carry)
        self._record(out[self.seg_len - 1])
        return out

    def seg_scan(self, x: torch.Tensor, flag: torch.Tensor, op: str, init) -> torch.Tensor:
        out = self._scan(x, flag, op, self._carry(init))
        self._record(out[..., self.seg_len - 1])
        return out

    def seg_cumsum(self, x, reset):
        return self.seg_scan(x, reset, "add", 0)

    def seg_cummax(self, x, reset):
        return self.seg_scan(x, reset, "max", 0)

    def seg_cumor(self, x, reset):
        return self.seg_scan(x, reset, "or", 0)

    def next_marked(self, x, mark, init=0):
        raise NotImplementedError("right-to-left broadcast is the phase-B reverse sweep, not an op")

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sum(x[: self.seg_len])


def _seen_right(mark: torch.Tensor) -> torch.Tensor:
    """True where a mark lies at or after the position."""
    return torch.cumsum(mark.flip(0).to(torch.int32), 0).flip(0) > 0


def _pack(bwt, bwt_sub, qs_out, valid) -> torch.Tensor:
    """u16 (quality << 8 | base) at base positions, 0 elsewhere."""
    is_char = (bwt != alphabet.TERM) & (bwt != alphabet.SIGMA) & valid
    return torch.where(is_char, (qs_out.to(torch.int32) << 8) | bwt_sub.to(torch.int32), 0).to(
        torch.uint16
    )


def _part1_segment(bwtpre, qs, lcp, base, n, carries, cfg: SmoothConfig, seg_len: int, fix_cap: int,
                   scans: LocalScanOps = LOCAL_OPS):
    """cluster_words + apply on one [seg_len + halo] window, forward pass.

    bwtpre packs the 3-bit BWT symbol and the 3-bit smoothing predecessor
    (bwt | pre << 3).  The decision word is broadcast over the whole window,
    halo included; positions whose cluster extends past the window
    ("pending") are applied with word 0, a no-op, and re-applied by _fix_tail
    once the later segments have produced the closing word.  Returns the
    packed u16 output, the stats, the scan carries, one int64 tensor of six
    scalars (first-close word, any close, modified and smoothed counts, any
    pending, fallback), the fix-cap tail slices and the full word / close /
    in-cluster arrays (fetched only for a fallback segment, whose pending
    region exceeds fix_cap).  `scans` runs every scan (a check passes the
    plain version)."""
    bwt = bwtpre & 7
    pre = bwtpre >> 3
    ops = SeqChunkOps(base, seg_len, carries, scans)
    word, close_mark, in_cluster, stats = cluster_words(bwt, qs, lcp.to(torch.int32), n, cfg, pre, ops)
    cm = close_mark[:seg_len]
    any_close = cm.any()
    first_word = torch.where(any_close, word[torch.argmax(cm.to(torch.uint8))], 0)

    # a cluster spanning the WINDOW end gives a spurious close at the last
    # window position (shift_next fills False past the edge) with a partial
    # decision word: mask it unless the data truly ends inside this window
    at_end = (base + bwt.shape[0]) >= n
    cm_w = close_mark.clone()
    cm_w[-1] = close_mark[-1] & at_end
    w_ext = scans.next_marked(torch.where(cm_w, word, 0), cm_w, init=0)
    seen = _seen_right(cm_w)
    w_use = torch.where(seen, w_ext, 0)[:seg_len]

    bwt_t, qs_t, pre_t = bwt[:seg_len], qs[:seg_len], pre[:seg_len]
    inclu_t = in_cluster[:seg_len]
    bwt_sub, qs_out, modified, smoothed = apply_words(bwt_t, qs_t, pre_t, w_use, inclu_t, cfg)
    if cfg.binning:
        qs_out = illumina_bin(qs_out)
    pos = torch.arange(seg_len, dtype=base.dtype, device=bwt.device)
    valid = pos < (n - base)
    packed = _pack(bwt_t, bwt_sub, qs_out, valid)

    pending = inclu_t & ~seen[:seg_len] & valid
    fallback = (pending & (pos < seg_len - fix_cap)).any()
    scalars = torch.stack([
        first_word.to(torch.int64), any_close.to(torch.int64),
        (modified & valid).sum(), (smoothed & valid).sum(),
        pending.any().to(torch.int64), fallback.to(torch.int64),
    ])
    tail = slice(seg_len - fix_cap, seg_len)
    return (packed, stats, ops.carries_out, scalars,
            bwtpre[tail], qs_t[tail], pending[tail],
            word[:seg_len], close_mark[:seg_len], inclu_t)


def _fix_tail(bp_t, qs_t, pending, right_carry: int, cfg: SmoothConfig):
    """Re-apply the pending tail positions with the true carry word.  With
    word 0 the forward pass left them untouched, so the counts add."""
    bwt_t = bp_t & 7
    pre_t = bp_t >> 3
    w = torch.full(bwt_t.shape, right_carry, dtype=torch.int32, device=bwt_t.device)
    bwt_sub, qs_out, modified, smoothed = apply_words(bwt_t, qs_t, pre_t, w, pending, cfg)
    if cfg.binning:
        qs_out = illumina_bin(qs_out)
    packed = _pack(bwt_t, bwt_sub, qs_out, True)
    return packed, int(modified.sum()), int(smoothed.sum())


def _apply_segment(bwtpre, qs, word, close, inclu, right_carry: int, n_rem: int,
                   cfg: SmoothConfig, seg_len: int):
    """Phase B for a fallback segment: local decision-word broadcast + apply + pack."""
    w_local = LOCAL_OPS.next_marked(torch.where(close, word, 0), close, init=0)
    w = torch.where(_seen_right(close), w_local, right_carry)
    bwt_t = bwtpre[:seg_len] & 7
    pre_t = bwtpre[:seg_len] >> 3
    bwt_sub, qs_out, modified, smoothed = apply_words(bwt_t, qs[:seg_len], pre_t, w, inclu, cfg)
    if cfg.binning:
        qs_out = illumina_bin(qs_out)
    valid = torch.arange(seg_len, device=bwt_t.device) < n_rem
    packed = _pack(bwt_t, bwt_sub, qs_out, valid)
    return packed, int((modified & valid).sum()), int((smoothed & valid).sum())


def _sort_chunk(batch: ReadBatch, lo: int, hi: int, dev: torch.device):
    """Sort the suffixes of reads [lo, hi) on the device: the chunk's suffix
    positions (chunk-local) and 255-capped LCPs, as host arrays of its real
    positions.  The copies are synchronous, so the device holds one chunk."""
    lens = np.asarray(batch.lengths[lo:hi], np.int32)
    nloc = int(np.maximum(lens, 0).sum()) + int((lens >= 0).sum())
    ebwt = build_ebwt(
        torch.as_tensor(np.array(batch.seqs[lo:hi], np.uint8)).to(dev),
        torch.as_tensor(np.array(batch.quals[lo:hi], np.uint8)).to(dev),
        torch.as_tensor(lens).to(dev),
    )
    sa = ebwt.sa[:nloc].cpu().numpy()
    lcp = torch.clamp_max(ebwt.lcp[:nloc], 255).to(torch.uint8).cpu().numpy()
    return sa, lcp


def _in_text_order(sa: np.ndarray, packed: torch.Tensor, n_pad: int):
    """One segment's inversion sorted on the device: the text positions
    (SA - 1) mod n_pad of its suffixes in increasing order and their packed
    outputs, as host arrays, for a host scatter that writes in order."""
    target, order = torch.sort(torch.remainder(torch.as_tensor(sa).to(packed.device) - 1, n_pad))
    # CUDA indexes no uint16 tensor: gather the same bits as int16
    return target.cpu().numpy(), packed.view(torch.int16)[order].view(torch.uint16).cpu().numpy()


def _resolve_spill(spill, n_pad: int):
    """(Spill or None, whether this call created it), as the JAX package picks."""
    env_spill = os.environ.get("BFQ_EXT_SPILL")
    own = not isinstance(spill, Spill)
    if not own:
        sp = spill
    elif spill is True or (spill is None and env_spill != "0"
                           and (n_pad >= (1 << 26) or env_spill == "1")):
        sp = Spill()
    else:
        return None, False
    # a full scratch disk SIGBUSes the memmap writers mid-run: check the
    # projected footprint up front (~19 B/pos at the merge's peak, 27 with
    # 64-bit positions, plus the 2 B/pos packed output that smoothing
    # allocates while the overlapped merge still holds its inputs) and
    # degrade to in-RAM host arrays
    free = shutil.disk_usage(sp.dir).free
    need = n_pad * (29 if n_pad >= (1 << 31) else 21)
    if free < need:
        _LOG.warning(
            "spill dir %s has %.1f GB free but ~%.1f GB projected; falling back to in-RAM "
            "host arrays (set BFQ_SPILL_DIR to a larger volume to keep host memory bounded)",
            sp.dir, free / 1e9, need / 1e9,
        )
        if own:
            sp.close()
        return None, False
    return sp, own


def smooth_fastq_external(
    batch: ReadBatch,
    cfg: SmoothConfig | None = None,
    mem_bytes: int = 4 << 30,
    *,
    device="cuda",
    _seg_len: int | None = None,
    _reads_per_chunk: int | None = None,
    spill=None,
    out_path: str | None = None,
    report: dict | None = None,
) -> Tuple[ReadBatch, dict]:
    """Out-of-core engine.smooth_fastq: the same output, with device memory
    bounded by mem_bytes and, with spill active, host memory bounded too.

    spill: an io.spill.Spill, True (create one), False (in RAM), or None
    (auto: spill beyond 2^26 positions or with BFQ_EXT_SPILL=1).  out_path
    also streams the smoothed FASTQ to disk (headers '@').  report receives
    per-stage wall seconds and peak-RSS marks, n_chunks and n_segments,
    `spill` (whether the host arrays are spill files) and `spill_bytes`.
    The underscore knobs pin the chunk and segment sizes (tests force tiny
    ones to exercise every carry path)."""
    cfg = cfg or SmoothConfig()
    dev = resolve_device(device)
    if not native.ext_merge_available():
        raise RuntimeError("external mode needs the port's native merge (csrc/extmerge.cpp), "
                           "which the host C++ compiler c++ builds")
    n_reads, width = batch.seqs.shape
    wp = width + 1
    n_pad = n_reads * wp
    sp, own_spill = _resolve_spill(spill, n_pad)
    rep = report if report is not None else {}
    rep["spill"] = sp is not None
    try:
        # `running` joins a merge still running when a stage raises, before the spill closes
        with span("external.smooth_fastq"), contextlib.ExitStack() as running:
            return _run(batch, cfg, mem_bytes, dev, _seg_len, _reads_per_chunk, sp, out_path,
                        rep, running)
    except BaseException:
        if own_spill:
            sp.close()
        raise


_MERGE_INPUTS = ("text", "qtext", "sa_all", "lcp_all")
_MERGE_OUTPUTS = ("bwt", "qs", "lcp", "pre", "sa")


class _Merge:
    """The k-way merge, overlapped with smoothing or (overlap=False) run to
    its end on start().

    It holds the merge's inputs and, with spill files, the watcher that
    drops their finished pages, until the merge has joined.  wait(pos)
    blocks until the merged prefix covers pos and adds the seconds blocked
    to merge_wait_s; finish() joins the merge, raises its error in the
    caller's thread, and drops the inputs; close() joins a merge that is
    still running when a later stage raised, so that nothing writes into
    the spill files once they close."""

    def __init__(self, inputs, outputs, sp, overlap: bool, rep: dict, mark):
        self.inputs = inputs  # text, qtext, (sa_all, offs), lcp_all
        self.outputs = outputs
        self.sp = sp
        self.overlap = overlap
        self.rep = rep
        self.mark = mark
        self.handle = None
        self.watcher = None
        self.done = False
        self.wait_s = 0.0

    def start(self) -> None:
        self.t0 = time.time()
        self.rep["overlap"] = self.overlap
        if self.sp is not None:
            # the merge streams k cursors through the inputs and writes its
            # outputs in order; the watcher keeps dropping finished pages
            self.watcher = self.sp.watcher(*_MERGE_INPUTS, *_MERGE_OUTPUTS)
            self.watcher.__enter__()
        text, qtext, sa_chunks, lcp_all = self.inputs
        if self.overlap:
            self.handle = native.ext_merge_async(text, qtext, sa_chunks, lcp_chunks=lcp_all,
                                                 out=self.outputs)
        else:
            with span("external.merge_wait"):  # smoothing waits for the whole merge
                native.ext_merge(text, qtext, sa_chunks, lcp_all, out=self.outputs)
            self.finish()

    def wait(self, pos: int) -> None:
        if self.done:
            return
        t = time.time()
        if self.handle.merged_prefix() < pos:
            with span("external.merge_wait"):
                self.handle.wait_until(pos)
        self.wait_s += time.time() - t
        if self.handle.finished(0):
            self.finish()  # the inputs go as soon as the merge has ended

    def finish(self) -> None:
        if self.done:
            return
        self.done = True
        try:
            if self.handle is not None:
                self.handle.join()
                self.rep["merge_wait_s"] = round(self.wait_s, 2)
                self.rep["merge_prefix_s"] = {str(f): round(t, 2) for f, t in self.handle.prefix_s.items()}
        finally:
            self._release()
        _LOG.info("stage 1: k-way merge done (%.1fs)", time.time() - self.t0)
        self.mark("merge", self.t0)

    def close(self) -> None:
        """After an error: wait for a running merge, then release it."""
        if self.done:
            return
        self.done = True
        if self.handle is not None:
            self.handle.finished()
        self._release()

    def _release(self) -> None:
        if self.watcher is not None:
            self.watcher.__exit__(None, None, None)
            self.sp.evict_all(*_MERGE_OUTPUTS)
            for name in _MERGE_INPUTS:
                self.sp.drop(name)
        self.inputs = None


def _pack_text(batch: ReadBatch, sp, reads_per_chunk: int):
    """(text, qtext): the reads as one [n_reads * (width + 1)] text of base
    codes + 1 (0 past each read's end) and its qualities, in spill files
    slab by slab when `sp` is a Spill, else in RAM."""
    n_reads, width = batch.seqs.shape
    wp = width + 1
    n_pad = n_reads * wp
    k = np.arange(wp)[None, :]
    if sp is None:
        text = np.where(
            k < batch.lengths[:, None], np.pad(batch.seqs, ((0, 0), (0, 1))).astype(np.uint8) + 1, 0
        ).reshape(-1)
        return text, np.pad(batch.quals, ((0, 0), (0, 1))).reshape(-1)
    text = sp.alloc("text", (n_pad,), np.uint8)
    qtext = sp.alloc("qtext", (n_pad,), np.uint8)
    slab = max(min(reads_per_chunk, (64 << 20) // wp), 1)
    for lo in range(0, n_reads, slab):
        hi = min(lo + slab, n_reads)
        text[lo * wp : hi * wp] = np.where(
            k < np.asarray(batch.lengths[lo:hi])[:, None],
            np.pad(np.asarray(batch.seqs[lo:hi]), ((0, 0), (0, 1))).astype(np.uint8) + 1, 0,
        ).reshape(-1)
        qtext[lo * wp : hi * wp] = np.pad(np.asarray(batch.quals[lo:hi]), ((0, 0), (0, 1))).reshape(-1)
        Spill.evict(text, lo * wp, (hi - lo) * wp)
        Spill.evict(qtext, lo * wp, (hi - lo) * wp)
        Spill.evict(batch.seqs, lo * width, (hi - lo) * width)
        Spill.evict(batch.quals, lo * width, (hi - lo) * width)
    return text, qtext


def _run(batch, cfg, mem_bytes, dev, seg_len_arg, rpc_arg, sp, out_path, rep, running):
    n_reads, width = batch.seqs.shape
    wp = width + 1
    n_pad = n_reads * wp

    def mark(stage, t0):
        rep[f"{stage}_s"] = round(time.time() - t0, 2)
        rep[f"{stage}_peak_rss_gb"] = round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6, 2)

    # ---- stage 1: chunked device sorts ----
    t_text = time.time()
    route = build_route(width)
    reads_per_chunk = rpc_arg or max(int(mem_bytes / _build_bytes_per_pos(width) / wp), 1)
    spill_at = sp.allocated if sp is not None else 0
    with span("external.pack_text"):
        text, qtext = _pack_text(batch, sp, reads_per_chunk)

    n_chunks = -(-n_reads // reads_per_chunk)
    _LOG.info("stage 1: %d reads in %d device chunks of <=%d (%s build)%s", n_reads, n_chunks,
              reads_per_chunk, route, f" (spill: {sp.dir})" if sp is not None else "")
    # global suffix positions overflow int32 beyond 2^31 positions; the
    # 64-bit merge takes over, and BFQ_EXT_SA64=1 forces it
    wide = n_pad >= (1 << 31) or os.environ.get("BFQ_EXT_SA64") == "1"
    sa_dtype = np.int64 if wide else np.int32
    if sp is not None:
        sa_store = sp.alloc("sa_all", (n_pad,), sa_dtype)
        lcp_store = sp.alloc("lcp_all", (n_pad,), np.uint8)
    else:
        sa_store = np.empty(n_pad, sa_dtype)
        lcp_store = np.empty(n_pad, np.uint8)
    offs = [0]
    t0 = time.time()
    for ci, lo in enumerate(range(0, n_reads, reads_per_chunk)):
        hi = min(lo + reads_per_chunk, n_reads)
        with span("external.sort_chunk"):
            sa_c, lcp_c = _sort_chunk(batch, lo, hi, dev)
            base, nloc = offs[-1], sa_c.shape[0]
            sa_store[base : base + nloc] = (sa_c.astype(np.int64) + lo * wp).astype(sa_dtype)
            lcp_store[base : base + nloc] = lcp_c
        offs.append(base + nloc)
        if sp is not None:
            Spill.evict(sa_store, base * sa_store.itemsize, nloc * sa_store.itemsize)
            Spill.evict(lcp_store, base, nloc)
            # a spill-backed input batch (read_fastq_spill): these rows are consumed
            Spill.evict(batch.seqs, lo * width, (hi - lo) * width)
            Spill.evict(batch.quals, lo * width, (hi - lo) * width)
        _LOG.info("stage 1: chunk %d/%d done (%.1fs elapsed)", ci + 1, n_chunks, time.time() - t0)
    n = offs[-1]
    rep["n_chunks"] = n_chunks
    mark("chunk_sorts", t_text)

    # ---- the k-way merge: smoothing consumes its merged prefix live ----
    if sp is not None:
        outputs = tuple(sp.alloc(name, (n,), np.uint8) for name in _MERGE_OUTPUTS[:4]) + (
            sp.alloc("sa", (n,), sa_dtype),)
    else:
        outputs = tuple(np.empty(n, np.uint8) for _ in range(4)) + (np.empty(n, sa_dtype),)
    bwt_h, qs_h, lcp_h, pre_h, sa_h = outputs
    merge = _Merge((text, qtext, (sa_store[:n], np.asarray(offs, np.int64)), lcp_store[:n]), outputs,
                   sp, os.environ.get("BFQ_EXT_OVERLAP", "1") != "0", rep, mark)
    running.callback(merge.close)  # joined before the caller closes the spill
    text = qtext = sa_store = lcp_store = None  # the merge holds them until it joins
    merge.start()

    # ---- stage 2: streaming cluster smoothing (forward pass applies) ----
    # (no longer than the data: the JAX package's one compiled shape needs
    # no padding here)
    seg_len = seg_len_arg or min(max(int(mem_bytes / _SMOOTH_BYTES_PER_POS), 1 << 16), n)
    # right lookahead: close_mark/open_mark at seg_len-1 reach pred at
    # seg_len+m-2, which reads lcp at seg_len+m-1
    halo = cfg.min_cluster + 4
    n_seg = -(-n // seg_len)
    fix_cap = min(4096, seg_len)
    # the segments carry GLOBAL positions (the run-start / last-gap cummax
    # carries of cluster_words), so coordinates follow the SA's width
    idx_dtype = torch.int64 if wide else torch.int32

    def upload(arr):
        return torch.as_tensor(arr).to(dev)

    def seg_slice(arr, s, fill):
        lo = s * seg_len
        out = arr[lo : min(lo + seg_len + halo, n)]
        pad = seg_len + halo - out.size
        if pad:
            out = np.concatenate([out, np.full(pad, fill, arr.dtype)])
        return upload(np.ascontiguousarray(out))

    def seg_slice_bp(s):
        # bwt | pre << 3, packed on the host: one 3 B/pos upload instead of 4
        lo = s * seg_len
        hi = min(lo + seg_len + halo, n)
        out = bwt_h[lo:hi] | (pre_h[lo:hi] << np.uint8(3))
        pad = seg_len + halo - out.size
        if pad:
            out = np.concatenate([out, np.full(pad, alphabet.SIGMA, np.uint8)])
        return upload(out)

    _LOG.info("stage 2: streaming smooth over %d segments of %d", n_seg, seg_len)
    t_smooth = time.time()
    packed_h = sp.alloc("packed", (n_pad,), np.uint16) if sp is not None else np.zeros(n_pad, np.uint16)
    firsts, anys = [], []
    tails = {}  # s -> (bwtpre, qs, pending) fix-cap slices, on the host
    fallbacks = {}  # s -> (word, close, inclu) whole segments, on the host (rare)
    seg_mod = np.zeros(n_seg, np.int64)
    seg_smo = np.zeros(n_seg, np.int64)
    stats_acc: dict = {}
    carries = None
    n_t = torch.tensor(n, dtype=idx_dtype, device=dev)
    t0 = time.time()
    for s in range(n_seg):
        # this segment's window, halo included, must be merged and final
        merge.wait(min((s + 1) * seg_len + halo, n))
        lo = s * seg_len
        hi = min(lo + seg_len, n)
        with span("external.segment"):
            (packed, stats, carries, scalars, tb, tq, tpend, word, close, inclu) = _part1_segment(
                seg_slice_bp(s), seg_slice(qs_h, s, 0), seg_slice(lcp_h, s, 0),
                torch.tensor(lo, dtype=idx_dtype, device=dev), n_t, carries,
                cfg, seg_len, fix_cap,
            )
            target, packed_seg = _in_text_order(sa_h[lo:hi], packed[: hi - lo], n_pad)
        with span("external.scatter"):
            packed_h[target] = packed_seg
        fw, ac, mod, smo, any_pend, fb = scalars.tolist()
        firsts.append(fw)
        anys.append(bool(ac))
        seg_mod[s] = mod
        seg_smo[s] = smo
        if fb:
            # a cluster spans (nearly) the whole segment: keep its decisions
            # for a whole-segment re-apply in phase B
            fallbacks[s] = (word.cpu().numpy(), close.cpu().numpy(), inclu.cpu().numpy())
        elif any_pend:
            tails[s] = (tb.cpu().numpy(), tq.cpu().numpy(), tpend.cpu().numpy())
        for key, v in zip(stats, torch.stack(list(stats.values())).tolist()):
            stats_acc[key] = stats_acc.get(key, 0) + v
        if sp is not None and s > 0:
            # the previous segment (minus the halo read now) is consumed
            plo = (s - 1) * seg_len
            for arr in (bwt_h, qs_h, lcp_h, pre_h):
                Spill.evict(arr, plo, seg_len)
            Spill.evict(sa_h, plo * sa_h.itemsize, seg_len * sa_h.itemsize)
        # the next segment's device peak holds none of this one's arrays
        del packed, target, packed_seg, stats, scalars, tb, tq, tpend, word, close, inclu
        _LOG.info("stage 2: segment %d/%d done (%.1fs elapsed)", s + 1, n_seg, time.time() - t0)
    del carries
    merge.finish()

    # phase B: reverse sweep of the first-close words + the small fix-ups
    with span("external.phase_b"):
        right_carry = np.zeros(n_seg, np.int64)
        carry = 0
        for s in range(n_seg - 1, -1, -1):
            right_carry[s] = carry
            if anys[s]:
                carry = firsts[s]
        for s, (tb, tq, tpend) in tails.items():
            if right_carry[s] == 0:
                continue  # no later cluster close: word 0 was already right
            pk, mod, smo = _fix_tail(upload(tb), upload(tq), upload(tpend), int(right_carry[s]), cfg)
            idx = np.flatnonzero(tpend)
            target = (sa_h[s * seg_len + seg_len - fix_cap + idx].astype(np.int64) - 1) % n_pad
            packed_h[target] = pk.cpu().numpy()[idx]
            seg_mod[s] += mod
            seg_smo[s] += smo
        for s, (word_s, close_s, inclu_s) in fallbacks.items():
            lo = s * seg_len
            hi = min(lo + seg_len, n)
            packed, mod, smo = _apply_segment(
                seg_slice_bp(s), seg_slice(qs_h, s, 0), upload(word_s), upload(close_s),
                upload(inclu_s), int(right_carry[s]), min(n - lo, seg_len + 1), cfg, seg_len,
            )
            target, packed_seg = _in_text_order(sa_h[lo:hi], packed[: hi - lo], n_pad)
            packed_h[target] = packed_seg
            seg_mod[s] = mod  # the whole-segment recompute replaces the forward pass's
            seg_smo[s] = smo
    stats_acc["modified"] = int(seg_mod.sum())
    stats_acc["qs_smoothed"] = int(seg_smo.sum())
    rep["n_segments"] = n_seg
    mark("smooth", t_smooth)

    # ---- stage 3: emission (the scatters above were the inversion) ----
    t_emit = time.time()
    with span("external.emit"):
        lengths_out = np.asarray(batch.lengths).astype(np.int32)
        if sp is None:
            grid = packed_h.reshape(n_reads, wp)
            seqs = (grid[:, :width] & 0xFF).astype(np.uint8)
            quals = ((grid[:, :width] >> 8) & 0xFF).astype(np.uint8)
            if out_path:
                write_fastq(out_path, ReadBatch(seqs=seqs, quals=quals, lengths=lengths_out), headers=None)
        else:
            seqs = sp.alloc("out_seqs", (n_reads, width), np.uint8)
            quals = sp.alloc("out_quals", (n_reads, width), np.uint8)
            slab = max((64 << 20) // wp, 1)
            with open(out_path, "wb") if out_path else contextlib.nullcontext() as fh:
                for lo in range(0, n_reads, slab):
                    hi = min(lo + slab, n_reads)
                    grid = np.asarray(packed_h[lo * wp : hi * wp]).reshape(hi - lo, wp)
                    s_s = (grid[:, :width] & 0xFF).astype(np.uint8)
                    q_s = ((grid[:, :width] >> 8) & 0xFF).astype(np.uint8)
                    seqs[lo:hi] = s_s
                    quals[lo:hi] = q_s
                    if fh is not None:
                        fh.write(fastq_array(ReadBatch(seqs=s_s, quals=q_s, lengths=lengths_out[lo:hi])))
                    Spill.evict(packed_h, lo * wp * 2, (hi - lo) * wp * 2)
                    Spill.evict(seqs, lo * width, (hi - lo) * width)
                    Spill.evict(quals, lo * width, (hi - lo) * width)
            for name in ("packed", "bwt", "qs", "lcp", "pre", "sa"):
                sp.drop(name)
    out = ReadBatch(seqs=seqs, quals=quals, lengths=lengths_out, headers=batch.headers)
    rep["spill_bytes"] = sp.allocated - spill_at if sp is not None else 0
    mark("emit", t_emit)
    return out, stats_acc

"""Sequence-sharded end-to-end pipeline: ONE global EBWT, smoothed and
inverted across ranks, with no per-block compression-ratio cost.

Port of bfqzip_tpu/parallel/global_pipeline.py.  Each rank runs:

  1. the distributed suffix sort (global_ebwt._sort_body);
  2. the EXACT rebalance of the sorted order to equal contiguous [m] slices
     (Ctx.rebalance: the diagonal stays put, only the sample-sort drift
     rides an all_to_all);
  3. cluster smoothing with ops/smooth.py on DistScanOps: every segmented
     scan is the local one (the CUDA kernel on the card) plus one carry
     step; the predecessor symbols ride the flat sort's payload, or come
     from one routed gather of text[(SA - 2) mod n_pad];
  4. inversion as ONE routed scatter of the packed qs << 8 | base word to
     text position (SA - 1) mod n_pad; ranks own whole reads, so the
     scatter is the reconstruction.

Every exchange reports bucket overflow; the wrappers retry with doubled
capacity, and raise if the last attempt still overflows.  The output is
the single-device engine.smooth_fastq's, at the input's raw width.

`smooth_rank` is one rank's body; multihost.smooth_fastq_sharded_multihost
wraps it for a rank of any process group, and `smooth_fastq_sharded` below
spawns `shards` ranks from one process.
"""

from __future__ import annotations

import contextlib
import tempfile
from typing import Tuple

import numpy as np
import torch

from bfqzip_tpu_torch import alphabet
from bfqzip_tpu_torch.config import SmoothConfig
from bfqzip_tpu_torch.io.fastq import ReadBatch
from bfqzip_tpu_torch.ops import cuda_scan
from bfqzip_tpu_torch.ops.invert import illumina_bin
from bfqzip_tpu_torch.ops.smooth import smooth
from bfqzip_tpu_torch.ops.suffix import EbwtDevice
from bfqzip_tpu_torch.parallel import mesh
from bfqzip_tpu_torch.parallel.comm import Comm
from bfqzip_tpu_torch.parallel.dist_scan import DistScanOps
from bfqzip_tpu_torch.parallel.global_ebwt import (ATTEMPTS, Ctx, _sort_body, local_rows,
                                                   pad_reads_to_multiple)
from bfqzip_tpu_torch.utils.profiling import span


@contextlib.contextmanager
def _stage(name: str, dev: torch.device, stages: dict | None):
    """The span `sharded.<name>`.  With `stages` (a report was asked for)
    the span is timed even where no span is recorded, and kept there as
    `<name>_ms`; on CUDA the device's peak counter is reset on entry and
    read on exit as `<name>_peak_bytes`, the allocator's own bookkeeping, so
    nothing waits for the card."""
    cuda = stages is not None and dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    with span("sharded." + name, timed=stages is not None) as sp:
        yield
    if stages is not None:
        stages[name + "_ms"] = sp
    if cuda:
        stages[name + "_peak_bytes"] = torch.cuda.max_memory_allocated(dev)


def _pipeline_body(ctx: Ctx, n_reads, width, seqs_l, quals_l, lens_l, cfg: SmoothConfig, stages):
    m, n_pad, dev = ctx.m, ctx.n_pad, ctx.dev
    wp = width + 1
    with _stage("sort", dev, stages):
        r = _sort_body(ctx, n_reads, width, seqs_l, quals_l, lens_l)

    # ---- exact rebalance: sorted order as equal contiguous [m] slices ----
    with _stage("rebalance", dev, stages):
        payloads = [(r.bwt, alphabet.SIGMA), (r.qs, 0), (r.lcp, 0), (r.sa, -1)]
        if r.pre is not None:
            (bwt_e, qs_e, lcp_e, sa_e, pre), ovf = ctx.rebalance(r.count, payloads + [(r.pre, 0)])
        else:
            (bwt_e, qs_e, lcp_e, sa_e), ovf = ctx.rebalance(r.count, payloads)
            # predecessor symbols: text[(SA - 2) mod n_pad]
            prev2 = torch.remainder(sa_e.to(torch.int64) - 2, n_pad)
            tprev2, ovf_pre = ctx.global_gather(r.text, prev2, 0)
            ovf = ovf + ovf_pre
            pre = torch.where(tprev2 == 0, alphabet.TERM, tprev2 - 1).to(torch.uint8)
        del r.bwt, r.qs, r.lcp, r.sa

    # ---- cluster smoothing on the distributed scan ops ----
    with _stage("smooth", dev, stages):
        ops = DistScanOps(ctx.comm)
        ebwt = EbwtDevice(bwt=bwt_e, qs=qs_e, lcp=lcp_e, sa=sa_e, text=r.text, n=r.n)
        out = smooth(ebwt, cfg, pre=pre, ops=ops)
        del ebwt, qs_e, lcp_e, pre

    # ---- inversion: one routed scatter back to read coordinates ----
    with _stage("scatter", dev, stages):
        qs_fin = illumina_bin(out.qs) if cfg.binning else out.qs
        is_char = (bwt_e != alphabet.TERM) & (ops.iota(m, dev) < r.n)
        packed = torch.where(is_char, (qs_fin.to(torch.int32) << 8) | out.bwt_sub.to(torch.int32), 0)
        target = torch.remainder(sa_e.to(torch.int64) - 1, n_pad)
        grid, ovf_sc = ctx.global_scatter(packed, target, 0)
        grid = grid.reshape(m // wp, wp)[:, :width]
        seqs_o = (grid & 0xFF).to(torch.uint8)
        quals_o = ((grid >> 8) & 0xFF).to(torch.uint8)
        lengths_o = (seqs_o != 0).sum(dim=1, dtype=torch.int32)
        overflow = r.overflow + ctx.comm.psum(ovf + ovf_sc)
    return seqs_o, quals_o, lengths_o, out.stats, overflow


def smooth_rank(seqs_l, quals_l, lens_l, comm: Comm, cfg: SmoothConfig,
                capacity_factor: float = 2.5, report: dict | None = None):
    """One rank's share of the sequence-sharded pipeline: this rank's
    contiguous [N/d, L] slice of the reads as tensors on comm.device (every
    rank's slice of the same shape) in, its smoothed slice and the global
    stats (0-d tensors) out.  Each attempt reads one overflow count on the
    host; the capacity doubles on overflow, ATTEMPTS times at most.  With a
    `report` dict, each attempt's capacity and overflow, and the last
    attempt's stage milliseconds, collective bytes, host-staged bytes and
    seg_scan launches are written there; on CUDA also each stage's peak
    device bytes (the device's peak statistics are reset at each stage).
    A stage's milliseconds are those of its span `sharded.<stage>`: CUDA
    events on the card, read once the attempt's overflow count is on the
    host, else the host clock; no stage waits for the card.  Without a
    report, no stage is timed for one and no peak counter is reset."""
    d = comm.d
    n_local, width = seqs_l.shape
    n_reads = n_local * d
    wp = width + 1
    n_pad = n_reads * wp
    m = n_pad // d
    for _ in range(ATTEMPTS):
        sent, staged, launches = comm.sent_bytes, comm.staged_bytes, cuda_scan.launches
        stages = None if report is None else {}
        cap_sorted = int(capacity_factor * m) + 64
        rebalance_cap = min(int(capacity_factor * m / 8) + 1024, m)
        ctx = Ctx(comm, m, n_pad, cap_sorted, rebalance_cap=rebalance_cap)
        seqs_o, quals_o, lengths_o, stats, overflow = _pipeline_body(
            ctx, n_reads, width, seqs_l, quals_l, lens_l, cfg, stages)
        overflow = int(overflow)
        if report is not None:
            # the spans' ms, read now that the overflow count is on the host
            report.update({k: v.ms if k.endswith("_ms") else v for k, v in stages.items()})
            report.setdefault("attempts", []).append(
                {"capacity_factor": capacity_factor, "overflow": overflow})
            report.update(sent_bytes=comm.sent_bytes - sent, staged_bytes=comm.staged_bytes - staged,
                          seg_scan_launches=cuda_scan.launches - launches)
        if overflow == 0:
            return seqs_o, quals_o, lengths_o, stats
        capacity_factor *= 2
    raise RuntimeError(f"sequence-sharded pipeline: bucket overflow of {overflow} elements "
                       f"after {ATTEMPTS} attempts (last capacity factor {capacity_factor / 2})")


def _rank(comm, seqs, quals, lengths, out_seqs, out_quals, out_lengths, cfg, capacity_factor,
          with_report):
    """A spawned rank: its rows of the shared inputs in, its rows of the
    shared outputs written; returns the stats and the rank's report (None
    unless `with_report`)."""
    rows = seqs.shape[0] // comm.d
    lo, hi = comm.rank * rows, (comm.rank + 1) * rows
    report = {} if with_report else None
    with span("sharded.smooth_fastq"):
        s, q, ln, stats = smooth_rank(seqs[lo:hi].to(comm.device), quals[lo:hi].to(comm.device),
                                      lengths[lo:hi].to(comm.device), comm, cfg, capacity_factor,
                                      report)
        out_seqs[lo:hi] = s.cpu()
        out_quals[lo:hi] = q.cpu()
        out_lengths[lo:hi] = ln.cpu()
    return {k: int(v) for k, v in stats.items()}, report


def smooth_fastq_sharded(
    batch: ReadBatch,
    cfg: SmoothConfig | None = None,
    shards: int = 2,
    device="cuda",
    capacity_factor: float = 2.5,
    backend: str | None = None,
    work_dir: str | None = None,
    reports: list | None = None,
    comm: Comm | None = None,
) -> Tuple[ReadBatch, dict]:
    """Host wrapper: numpy ReadBatch in, smoothed numpy ReadBatch out (raw
    width), with ONE global EBWT over several ranks.

    With `comm`, this process is one rank of that group (the counterpart of
    the JAX wrapper's mesh): every rank passes the whole batch and gets the
    whole result, and `shards`, `device`, `backend` and `work_dir` are the
    group's.  Without it, `shards` ranks are spawned from this process: on
    CUDA each takes its own card (fewer cards than shards raises) unless
    backend="gloo" puts them all on `device`; on the CPU they are gloo
    ranks.  Inputs and outputs then pass through shared-memory CPU tensors,
    the rendezvous through a file in work_dir.  Each rank's report (see
    smooth_rank) is appended to `reports`."""
    cfg = cfg or SmoothConfig()
    if comm is not None:
        return _smooth_on(batch, cfg, comm, capacity_factor, reports)
    mesh.check_world(shards, device, backend)
    seqs, quals, lengths = pad_reads_to_multiple(batch.seqs, batch.quals, batch.lengths, shards)
    shared = [torch.from_numpy(np.ascontiguousarray(a)).share_memory_()
              for a in (seqs, quals, lengths.astype(np.int32))]
    outs = [torch.zeros_like(t).share_memory_() for t in shared]
    results = mesh.spawn(_rank, shards, device, work_dir or tempfile.gettempdir(),
                         args=(*shared, *outs, cfg, capacity_factor, reports is not None),
                         backend=backend)
    if reports is not None:
        reports.extend(rep for _, rep in results)
    n0 = batch.num_reads
    out = ReadBatch(seqs=outs[0][:n0].numpy(), quals=outs[1][:n0].numpy(),
                    lengths=outs[2][:n0].numpy(), headers=batch.headers)
    return out, results[0][0]


def _smooth_on(batch: ReadBatch, cfg: SmoothConfig, comm: Comm, capacity_factor: float,
               reports: list | None) -> Tuple[ReadBatch, dict]:
    """smooth_fastq_sharded as one rank of `comm`: this rank's rows of the
    whole batch in, every rank's smoothed rows gathered out, all inside the
    call's root span `sharded.smooth_fastq`."""
    with span("sharded.smooth_fastq"):
        with span("sharded.pad"):
            seqs, quals, lengths = pad_reads_to_multiple(batch.seqs, batch.quals, batch.lengths,
                                                         comm.d)
        with span("sharded.upload"):
            local = local_rows((seqs, quals, lengths.astype(np.int32)), comm)
        report = None if reports is None else {}
        s, q, ln, stats = smooth_rank(*local, comm, cfg, capacity_factor, report)
        if reports is not None:
            reports.append(report)
        n0 = batch.num_reads
        with span("sharded.gather"):
            out = ReadBatch(**{k: comm.all_gather(v).flatten(0, 1)[:n0].cpu().numpy()
                               for k, v in (("seqs", s), ("quals", q), ("lengths", ln))},
                            headers=batch.headers)
    return out, {k: int(v) for k, v in stats.items()}

"""Rank bodies for the port's multi-rank tests (tests/test_torch_parallel*.py).

Each function runs on every rank of a world that
bfqzip_tpu_torch.parallel.mesh.spawn starts, so this module imports only
numpy, torch and the port: a spawned rank imports it by name and never
imports jax.  Inputs are whole host arrays; each rank takes its contiguous
share, and the test joins the ranks' results in rank order.
"""

import numpy as np
import torch

from bfqzip_tpu_torch.config import SmoothConfig
from bfqzip_tpu_torch.io.fastq import ReadBatch
from bfqzip_tpu_torch.parallel.dist_scan import DistScanOps
from bfqzip_tpu_torch.parallel.global_ebwt import build_ebwt_sharded
from bfqzip_tpu_torch.parallel.global_pipeline import smooth_fastq_sharded
from bfqzip_tpu_torch.parallel.multihost import smooth_fastq_sharded_multihost
from bfqzip_tpu_torch.parallel.sharded_sort import sharded_sort

# DistScanOps cases: name -> (method, argument names, extra arguments)
SCAN_CASES = {
    "iota": ("iota", (), ()),
    "shift_prev": ("shift_prev", ("x",), (7,)),
    "shift_next": ("shift_next", ("x",), (7,)),
    "shift_next_k": ("shift_next_k", ("x",), (3, 9)),
    "cummax": ("cummax", ("x",), ()),
    "seg_cumsum": ("seg_cumsum", ("x", "flag"), ()),
    "seg_cumsum_c5": ("seg_cumsum", ("xc", "flag"), ()),
    "seg_cumor": ("seg_cumor", ("x", "flag"), ()),
    "seg_cummax": ("seg_cummax", ("x", "flag"), ()),
    "seg_scan_max": ("seg_scan", ("x", "flag"), ("max", 0)),
    "seg_scan_f64_add": ("seg_scan", ("xf", "flag"), ("add", 0.0)),
    "next_marked": ("next_marked", ("x", "mark"), (3,)),
    "sum": ("sum", ("x",), ()),
}


def _share(comm, a):
    """This rank's contiguous share of the last axis of a host array."""
    n = a.shape[-1] // comm.d
    return torch.as_tensor(np.ascontiguousarray(a[..., comm.rank * n:(comm.rank + 1) * n]))


def dist_scans(comm, arrays: dict) -> dict:
    ops = DistScanOps(comm)
    local = {k: _share(comm, v) for k, v in arrays.items()}
    out = {}
    for name, (method, names, extra) in SCAN_CASES.items():
        if method == "iota":
            r = ops.iota(local["x"].shape[0], "cpu")
        else:
            r = getattr(ops, method)(*(local[k] for k in names), *extra)
        out[name] = r.numpy()
    return out


def sorts(comm, x: np.ndarray):
    buf, count, overflow = sharded_sort(_share(comm, x), comm)
    return buf.numpy(), int(count), int(overflow)


def ebwts(comm, batches: dict) -> dict:
    """build_ebwt_sharded of each named (seqs, quals, lengths, capacity
    factor); rank 0 returns them as dicts of arrays."""
    got = {name: build_ebwt_sharded(s, q, ln, comm, capacity_factor=cf)._asdict()
           for name, (s, q, ln, cf) in batches.items()}
    return got if comm.rank == 0 else None


def smooths(comm, cases: dict) -> dict:
    """smooth_fastq_sharded on the group of each named (batch arrays, cfg
    fields, capacity factor): every rank passes the whole batch; rank 0
    returns (seqs, quals, lengths, stats, report) of each."""
    out = {}
    for name, ((seqs, quals, lengths), cfg_fields, capacity_factor) in cases.items():
        reports = []
        got, stats = smooth_fastq_sharded(ReadBatch(seqs=seqs, quals=quals, lengths=lengths),
                                          SmoothConfig(**cfg_fields), comm=comm,
                                          capacity_factor=capacity_factor, reports=reports)
        out[name] = (got.seqs, got.quals, got.lengths, stats, reports[0])
    return out if comm.rank == 0 else None


def pipelines(comm, cases: list) -> list:
    """(local smoothed batch, stats, report) of each (batch arrays, cfg
    fields, capacity factor): every rank feeds its share of the reads."""
    out = []
    for (seqs, quals, lengths), cfg_fields, capacity_factor in cases:
        n = seqs.shape[0] // comm.d
        lo, hi = comm.rank * n, (comm.rank + 1) * n
        local = ReadBatch(seqs=seqs[lo:hi], quals=quals[lo:hi], lengths=lengths[lo:hi])
        report = {}
        got, stats = smooth_fastq_sharded_multihost(local, SmoothConfig(**cfg_fields), comm,
                                                     capacity_factor=capacity_factor, report=report)
        out.append((got.seqs, got.quals, got.lengths, stats, report))
    return out


def fail_on_rank_1(comm):
    """Rank 1 raises while rank 0 waits for it in a collective."""
    if comm.rank == 1:
        raise ValueError("rank 1 gives up")
    return float(comm.psum(torch.ones(())))

"""Distributed sample sort over a process group.

Port of bfqzip_tpu/parallel/sharded_sort.py, the smallest of the
exchanges: local sort -> splitter agreement (all_gather of d local samples
per rank) -> fixed-capacity bucket exchange (all_to_all) -> local merge.
Skewed inputs that overflow a bucket report the overflow count, so the
caller can rerun with a larger factor.
"""

from __future__ import annotations

import torch

from bfqzip_tpu_torch.parallel.comm import Comm

SENTINEL = 2**31 - 1


def sharded_sort(x: torch.Tensor, comm: Comm, capacity_factor: float = 2.0):
    """Sort this rank's [m] int32 share of a global array whose shares all
    have the same size.  Returns (buf [d * cap], count, overflow) for this
    rank: buf ascending and padded with SENTINEL past count; the ranks'
    buffers in rank order hold the global sort."""
    d = comm.d
    m = x.shape[0]
    cap = int(capacity_factor * m / d) + 64
    dev = x.device
    xs, _ = torch.sort(x)
    step = max(m // d, 1)
    samples = xs[(torch.arange(d, device=dev) * step).clamp_max(m - 1)]
    allsamp, _ = torch.sort(comm.all_gather(samples).reshape(-1))  # [d * d]
    splitters = allsamp[torch.arange(1, d, device=dev) * d]  # [d - 1]

    bucket = torch.searchsorted(splitters, xs, right=True).to(torch.int32)
    ids = torch.arange(d, dtype=torch.int32, device=dev)
    starts = torch.searchsorted(bucket, ids)
    cnt = torch.searchsorted(bucket, ids, right=True) - starts
    overflow = torch.clamp_min(cnt - cap, 0).sum()

    cols = torch.arange(cap, device=dev)[None, :]
    src = torch.clamp_max(starts[:, None] + cols, m - 1)
    send = torch.where(cols < torch.clamp_max(cnt, cap)[:, None], xs[src], SENTINEL)  # [d, cap]
    buf, _ = torch.sort(comm.a2a(send).reshape(-1))  # sentinels sort last
    count = (buf != SENTINEL).sum()
    return buf, count, overflow

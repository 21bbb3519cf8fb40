"""Multi-process execution of the sequence-sharded pipeline.

Port of bfqzip_tpu/parallel/multihost.py.  Under torch.distributed a rank
is a process, so this is the per-rank entry point: every rank passes its
CONTIGUOUS equal-size share of the global read collection (rank order ==
read order; pad the collection so that its read count divides the world
size before slicing) and gets its share of the smoothed reads back, with
the global stats.  global_pipeline.smooth_fastq_sharded wraps it for a
one-process caller.

Launch one process per card, e.g. with torchrun (env:// rendezvous):

    from bfqzip_tpu_torch.parallel import multihost
    multihost.initialize()  # or initialize("tcp://host:port", world_size=W, rank=r)
    comm = multihost.global_comm()
    out_local, stats = multihost.smooth_fastq_sharded_multihost(local_batch, cfg, comm)

The group is NCCL unless the caller names another backend: with no card,
initialize() raises.  CPU ranks ask for it: initialize(backend="gloo").
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from bfqzip_tpu_torch.config import SmoothConfig
from bfqzip_tpu_torch.convert import batch_to_tensors
from bfqzip_tpu_torch.utils.profiling import resolve_device
from bfqzip_tpu_torch.io.fastq import ReadBatch
from bfqzip_tpu_torch.parallel.comm import Comm
from bfqzip_tpu_torch.parallel.global_pipeline import smooth_rank


def initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, backend: str = "nccl") -> None:
    """torch.distributed.init_process_group passthrough; with no arguments
    it reads torchrun's environment (env://).  The backend is nccl unless
    asked otherwise, and nccl without a card raises: the CPU takes
    backend="gloo", never by default."""
    if backend == "nccl":
        resolve_device("cuda")
    kw = {} if world_size is None else {"world_size": world_size, "rank": rank}
    dist.init_process_group(backend, init_method=init_method, **kw)


def global_comm(device=None) -> Comm:
    """The world group: one rank per process, an NCCL rank on card
    (rank mod the cards of its host), a gloo rank (which was asked for) on
    the CPU."""
    if device is None:
        if dist.get_backend() == "nccl":
            device = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
            torch.cuda.set_device(device)
        else:
            device = "cpu"
    return Comm(device)


def smooth_fastq_sharded_multihost(
    local_batch: ReadBatch,
    cfg: SmoothConfig | None = None,
    comm: Comm | None = None,
    capacity_factor: float = 2.5,
    report: dict | None = None,
) -> Tuple[ReadBatch, dict]:
    """This rank's share of the smoothed reads (raw width) and the global
    stats.  Every rank's share must have the same read count and width."""
    cfg = cfg or SmoothConfig()
    comm = comm if comm is not None else global_comm()
    shape = torch.tensor(local_batch.seqs.shape, dtype=torch.int64, device=comm.device)
    shapes = comm.all_gather(shape).cpu().numpy()
    if not (shapes == shapes[0]).all():
        raise ValueError(f"every rank must pass the same [reads, width]; got {shapes.tolist()}")
    seqs, quals, lengths = batch_to_tensors(local_batch, comm.device)
    s, q, ln, stats = smooth_rank(seqs, quals, lengths, comm, cfg, capacity_factor, report)
    out = ReadBatch(seqs=s.cpu().numpy(), quals=q.cpu().numpy(),
                    lengths=ln.cpu().numpy().astype(np.int32), headers=local_batch.headers)
    return out, {k: int(v) for k, v in stats.items()}

"""Process groups: the port's counterpart of bfqzip_tpu/parallel/mesh.py.

The JAX package builds a jax.sharding.Mesh over the devices of one process.
Here a rank is a process holding one device, and `init_group` joins this
process to a group of `world` ranks through a FileStore (a file in the run's
work directory, so no port is raced for).  `spawn` is how a one-process
caller reaches `world` ranks: it starts them with the spawn start method,
hands them CPU tensors in shared memory and collects what each returns.

Backends: NCCL for CUDA, one rank per card (a CUDA world larger than the
card count raises, as make_mesh does for too few devices); gloo for the
CPU.  A caller may ask for gloo on CUDA, which puts every rank on the given
card; comm.Comm then stages each collective through the host.
"""

from __future__ import annotations

import datetime
import os
import queue
import time
import traceback
import uuid

import torch
import torch.distributed as dist

from bfqzip_tpu_torch.parallel.comm import Comm

JOIN_TIMEOUT_S = 1800.0  # a rank that has not returned by then is killed


def check_world(world: int, device, backend: str | None = None) -> None:
    """Raise ValueError if `world` NCCL ranks do not each get their own card."""
    dev = torch.device(device)
    if dev.type == "cuda" and (backend or "nccl") == "nccl":
        count = torch.cuda.device_count()
        if world > count:
            raise ValueError(f"{world} ranks need {world} CUDA devices, "
                             f"torch.cuda.device_count() is {count}")


def init_group(rank: int, world: int, device, init_file: str, backend: str | None = None,
               timeout_s: float = JOIN_TIMEOUT_S) -> Comm:
    """Join the group of `world` ranks that meet at `init_file`.  The
    backend follows the device (nccl for cuda, gloo for cpu) unless given;
    an NCCL rank takes card `rank`, a gloo rank on CUDA the given card."""
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    check_world(world, dev, backend)
    if dev.type == "cuda":
        if backend == "nccl":
            dev = torch.device("cuda", rank)
        elif dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    os.makedirs(os.path.dirname(os.path.abspath(init_file)), exist_ok=True)
    store = dist.FileStore(init_file, world)
    kw = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return Comm(dev)


def factor2(n: int):
    """Factor n into the most balanced (a, b) with a*b == n."""
    best = (n, 1)
    for a in range(1, int(n**0.5) + 1):
        if n % a == 0:
            best = (n // a, a)
    return best


def _rank_main(fn, rank, world, device, backend, init_file, threads, args, results):
    try:
        torch.set_num_threads(threads)
        comm = init_group(rank, world, device, init_file, backend)
        try:
            out = fn(comm, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise


def spawn(fn, world: int, device, work_dir: str, args=(), backend: str | None = None,
          timeout_s: float | None = None) -> list:
    """Run fn(comm, *args) on `world` new ranks and return their results in
    rank order.  Tensors in `args` should be CPU tensors in shared memory
    (Tensor.share_memory_()); a rank writes its outputs into them.  Each
    rank takes an equal share of this process's torch threads.  A rank that
    raises, or a world that does not finish within timeout_s (default
    JOIN_TIMEOUT_S), raises here after every rank is stopped."""
    timeout_s = JOIN_TIMEOUT_S if timeout_s is None else timeout_s
    check_world(world, device, backend)
    if torch.device(device).type == "cuda" and torch.cuda.is_initialized():
        # the ranks' cards may be this process's: hand back the blocks its
        # caching allocator holds but does not use
        torch.cuda.empty_cache()
    os.makedirs(work_dir, exist_ok=True)
    init_file = os.path.join(work_dir, f".bfq_ranks_{os.getpid()}_{uuid.uuid4().hex}")
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    threads = max(1, torch.get_num_threads() // world)
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, str(device), backend, init_file, threads, args, results))
             for r in range(world)]
    outs: dict = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(outs) < world:
            try:
                rank, ok, out = results.get(timeout=max(deadline - time.monotonic(), 0.01))
            except queue.Empty:
                raise TimeoutError(f"{world - len(outs)} of {world} ranks did not finish "
                                   f"within {timeout_s} s") from None
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{out}")
            outs[rank] = out
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        if os.path.exists(init_file):
            os.remove(init_file)
    return [outs[r] for r in range(world)]

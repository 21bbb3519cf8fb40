"""Faults planted in every rank of a sharded run, for test_benchmark_faults.

`plant(name)` breaks the program in this process.  The test plants it in
rank 0 directly and in the other ranks through a sitecustomize module on
their PYTHONPATH, so every rank runs the same broken path (a fault in one
rank alone would leave the others waiting in a collective)."""

import torch

STATS = ("num_clust", "num_clust_discarded", "num_clust_amb_discarded", "num_clust_mod",
         "num_clust_alleq", "bases_inside", "modified", "qs_smoothed")


def plant(name: str, rank0: bool = True) -> list:
    """Apply fault `name`; returns (object, attribute, original) for undoing."""
    from bfqzip_tpu_torch import parallel
    from bfqzip_tpu_torch.io.fastq import ReadBatch
    from bfqzip_tpu_torch.ops.smooth import SmoothOut
    from bfqzip_tpu_torch.parallel import comm, global_pipeline

    from bfqzip_tpu_torch.parallel import mesh

    undo = []

    def patch(obj, attr, new):
        undo.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, new)

    # a broken group fails within seconds, not the harness's minutes
    real_init = mesh.init_group
    patch(mesh, "init_group", lambda *a, **kw: real_init(*a, **dict(kw, timeout_s=20.0)))

    if name == "jax_loaded":
        if not rank0:  # a module of the name only, in the other ranks alone
            import sys
            import types

            sys.modules.setdefault("jax", types.ModuleType("jax"))
    elif name == "exchange_left_out":
        real = comm.Comm.a2a

        def a2a(self, x):
            real(self, x)  # every rank still meets in the collective
            return torch.zeros_like(x)  # and nothing it sent arrives
        patch(comm.Comm, "a2a", a2a)
    elif name == "state_unchanged":
        def smooth(ebwt, cfg, pre=None, ops=None):
            zero = torch.zeros((), dtype=torch.int64, device=ebwt.bwt.device)
            return SmoothOut(bwt_sub=ebwt.bwt, qs=ebwt.qs, stats={k: zero for k in STATS})
        patch(global_pipeline, "smooth", smooth)
    elif name == "half_left_out":
        real_sharded = global_pipeline.smooth_fastq_sharded

        def sharded(batch, cfg=None, **kw):
            half = batch.num_reads // 2
            head = ReadBatch(seqs=batch.seqs[:half], quals=batch.quals[:half],
                             lengths=batch.lengths[:half])
            out, stats = real_sharded(head, cfg, **kw)
            import numpy as np
            return ReadBatch(seqs=np.concatenate([out.seqs, batch.seqs[half:]]),
                             quals=np.concatenate([out.quals, batch.quals[half:]]),
                             lengths=np.concatenate([out.lengths, batch.lengths[half:]])), stats
        patch(parallel, "smooth_fastq_sharded", sharded)
    elif name == "answer_altered":
        if rank0:
            real_sharded = global_pipeline.smooth_fastq_sharded

            def sharded(batch, cfg=None, **kw):
                out, stats = real_sharded(batch, cfg, **kw)
                seqs = out.seqs.copy()
                seqs[0, 0] = 1 + seqs[0, 0] % 5
                return ReadBatch(seqs=seqs, quals=out.quals, lengths=out.lengths), stats
            patch(parallel, "smooth_fastq_sharded", sharded)
    else:
        raise ValueError(name)
    return undo

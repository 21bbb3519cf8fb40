"""Faults of entry `cli_m3` (cli.main --m3 -> pipeline.run_pipeline, steps
1-5, on a FASTQ file with read names), planted by test_benchmark_faults.py
in what that route runs: step 3's smoother, step 4's cut of the DNA stream,
and the quality stream on its way into step 5's coder.

`FAULTS` maps each kind to a function of pytest's `monkeypatch` that plants
it; `SIZE` is the overrides (harness.load_cell) of the entry's CPU runs,
with a ratio ceiling for files of 2,000 reads (0.072 at the faults' seed;
a small file's models learn less than a 500K-read file's)."""

import numpy as np
import torch

from reference.ebwt import STATS

SIZE = {"count": 2000, "traffic": {"ratio_ceiling": 0.1}}


def state_unchanged(monkeypatch):
    """Step 3's smoother hands back the artifacts it was given."""
    from bfqzip_tpu_torch import engine
    from bfqzip_tpu_torch.ops.smooth import SmoothOut

    def smooth(ebwt, cfg, pre=None, ops=None):
        zero = torch.zeros((), dtype=torch.int64)
        return SmoothOut(bwt_sub=ebwt.bwt, qs=ebwt.qs, stats={k: zero for k in STATS})

    monkeypatch.setattr(engine, "smooth", smooth)


def half_left_out(monkeypatch):
    """Step 4 writes only the first half of the DNA lines."""
    from bfqzip_tpu_torch import pipeline

    real = pipeline._every_fourth

    def every_fourth(buf, starts, first):
        out = real(buf, starts, first)
        if first != 1:
            return out
        ends = np.flatnonzero(out == ord("\n"))
        return out[:ends[len(ends) // 2 - 1] + 1]

    monkeypatch.setattr(pipeline, "_every_fourth", every_fourth)


def answer_altered(monkeypatch):
    """One byte of the quality stream changes before step 5 encodes it (the
    .fq.qs file on disk stays as step 4 wrote it)."""
    from bfqzip_tpu_torch import pipeline

    real = pipeline.rans.encode_blob_best

    def encode_blob_best(data, *args, pos_reset=-1, **kw):
        if pos_reset == ord("\n"):  # the quality stream's positional contexts
            data = bytearray(data)
            data[0] ^= 1
        return real(bytes(data), *args, pos_reset=pos_reset, **kw)

    monkeypatch.setattr(pipeline.rans, "encode_blob_best", encode_blob_best)


FAULTS = {f.__name__: f for f in (state_unchanged, half_left_out, answer_altered)}

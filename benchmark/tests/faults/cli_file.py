"""Faults of entry `cli_file` (cli.main -> pipeline.run_pipeline on a FASTQ
file), planted by test_benchmark_faults.py in what that route runs: the
parse of the input, the smoother that step 3 reaches through
engine.smooth_arrays_step, and step 3's LF-walk inversion.

`FAULTS` maps each kind to a function of pytest's `monkeypatch` that plants
it; `SIZE` is the overrides (harness.load_cell) of the entry's CPU runs."""

import torch

from reference.ebwt import STATS

SIZE = {"count": 1200}


def state_unchanged(monkeypatch):
    """Step 3's smoother hands back the artifacts it was given."""
    from bfqzip_tpu_torch import engine
    from bfqzip_tpu_torch.ops.smooth import SmoothOut

    def smooth(ebwt, cfg, pre=None, ops=None):
        zero = torch.zeros((), dtype=torch.int64)
        return SmoothOut(bwt_sub=ebwt.bwt, qs=ebwt.qs, stats={k: zero for k in STATS})

    monkeypatch.setattr(engine, "smooth", smooth)


def half_left_out(monkeypatch):
    """The parse keeps only the first half of the file's reads."""
    from bfqzip_tpu_torch import pipeline
    from bfqzip_tpu_torch.io.fastq import ReadBatch

    real_read = pipeline.read_fastq

    def read_fastq(path, *args, **kw):
        b = real_read(path, *args, **kw)
        half = b.num_reads // 2
        return ReadBatch(seqs=b.seqs[:half], quals=b.quals[:half], lengths=b.lengths[:half],
                         headers=b.headers[:half] if b.headers else None)

    monkeypatch.setattr(pipeline, "read_fastq", read_fastq)


def answer_altered(monkeypatch):
    """One base of step 3's LF-walk output is flipped to another base code."""
    from bfqzip_tpu_torch import engine

    real = engine.invert

    def invert(*args, **kw):
        out = real(*args, **kw)
        seqs = out.seqs.clone()
        seqs[0, 0] = 1 + seqs[0, 0] % 5
        return out._replace(seqs=seqs)

    monkeypatch.setattr(engine, "invert", invert)


FAULTS = {f.__name__: f for f in (state_unchanged, half_left_out, answer_altered)}

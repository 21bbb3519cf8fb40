"""Faults of entry `smooth_fastq` (engine.smooth_fastq -> engine.smooth_step),
planted by test_benchmark_faults.py in what that route runs: the smoother
inside smooth_step, smooth_step itself, and its inversion through the
suffix array.

`FAULTS` maps each kind to a function of pytest's `monkeypatch` that plants
it; `SIZE` is the overrides (harness.load_cell) of the entry's CPU runs."""

import torch

from reference.ebwt import STATS

SIZE = {"count": 1200}


def state_unchanged(monkeypatch):
    """The smoother hands back the EBWT it was given."""
    from bfqzip_tpu_torch import engine
    from bfqzip_tpu_torch.ops.smooth import SmoothOut

    def smooth(ebwt, cfg, pre=None, ops=None):
        zero = torch.zeros((), dtype=torch.int64)
        return SmoothOut(bwt_sub=ebwt.bwt, qs=ebwt.qs, stats={k: zero for k in STATS})

    monkeypatch.setattr(engine, "smooth", smooth)


def half_left_out(monkeypatch):
    """Only the first half of the batch is smoothed; the rest comes back as given."""
    from bfqzip_tpu_torch import engine

    real_step = engine.smooth_step

    def smooth_step(seqs, quals, lengths, cfg):
        half = seqs.shape[0] // 2
        inv, stats = real_step(seqs[:half], quals[:half], lengths[:half], cfg)
        return inv._replace(seqs=torch.cat([inv.seqs, seqs[half:]]),
                            quals=torch.cat([inv.quals, quals[half:]]),
                            lengths=torch.cat([inv.lengths, lengths[half:]])), stats

    monkeypatch.setattr(engine, "smooth_step", smooth_step)


def answer_altered(monkeypatch):
    """One base of the inversion's output is flipped to another base code."""
    from bfqzip_tpu_torch import engine

    real = engine.invert_via_sa

    def invert_via_sa(*args, **kw):
        out = real(*args, **kw)
        seqs = out.seqs.clone()
        seqs[0, 0] = 1 + seqs[0, 0] % 5
        return out._replace(seqs=seqs)

    monkeypatch.setattr(engine, "invert_via_sa", invert_via_sa)


FAULTS = {f.__name__: f for f in (state_unchanged, half_left_out, answer_altered)}

"""Faults of entry `cli_ext` (cli.main --ext-mem -> external.smooth_fastq_external
on a FASTQ file), planted by test_benchmark_faults.py in what that route
runs: the forward smoothing pass of each segment, the streaming parse into
spill files, and the reads the fused steps 1-3 hand to the .fq writer.

`FAULTS` maps each kind to a function of pytest's `monkeypatch` that plants
it; `SIZE` is the overrides (harness.load_cell) of the entry's CPU runs: a
budget of 8 MB, so that 1200 reads take three chunk sorts and two smoothing
segments."""

import dataclasses

import torch

SIZE = {"count": 1200, "traffic": {"cli_args": ["-0", "--ext-mem", "--mem", "8", "-v", "1"]}}


def state_unchanged(monkeypatch):
    """Each segment's forward pass applies nothing: every base and quality
    leaves as it came in."""
    from bfqzip_tpu_torch import external

    def apply_words(bwt, qs, pre, word, in_cluster, cfg):
        none = torch.zeros_like(in_cluster)
        return bwt, qs, none, none

    monkeypatch.setattr(external, "apply_words", apply_words)


def half_left_out(monkeypatch):
    """The streaming parse keeps only the first half of the file's reads."""
    from bfqzip_tpu_torch.io import spill
    from bfqzip_tpu_torch.io.fastq import ReadBatch

    real_read = spill.read_fastq_spill

    def read_fastq_spill(path, sp, *args, **kw):
        b = real_read(path, sp, *args, **kw)
        half = b.num_reads // 2
        return ReadBatch(seqs=b.seqs[:half], quals=b.quals[:half], lengths=b.lengths[:half],
                         headers=b.headers[:half] if b.headers else None)

    monkeypatch.setattr(spill, "read_fastq_spill", read_fastq_spill)


def answer_altered(monkeypatch):
    """One base of the smoothed reads the .fq writer gets is flipped to
    another base code."""
    from bfqzip_tpu_torch import pipeline

    real = pipeline._write_smoothed

    def write_smoothed(batch, smoothed, base, cfg):
        seqs = smoothed.seqs.copy()
        seqs[0, 0] = 1 + seqs[0, 0] % 5
        return real(batch, dataclasses.replace(smoothed, seqs=seqs), base, cfg)

    monkeypatch.setattr(pipeline, "_write_smoothed", write_smoothed)


FAULTS = {f.__name__: f for f in (state_unchanged, half_left_out, answer_altered)}

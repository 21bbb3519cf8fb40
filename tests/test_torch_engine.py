"""The port's engine end to end on the CPU: byte-equal to the reference
binary's goldens and equal to the JAX engine on random batches."""

import numpy as np
import pytest

from bfqzip_tpu.config import SmoothConfig
from bfqzip_tpu.engine import smooth_fastq as jax_smooth_fastq
from bfqzip_tpu.io.fastq import format_fastq, read_fastq
from bfqzip_tpu_torch.engine import smooth_fastq

from conftest import golden_path
from tests_util import tiny_batch

_CFGS = {
    "m0b0": SmoothConfig(mode=0),
    "m1b0": SmoothConfig(mode=1),
    "m2b0": SmoothConfig(mode=2),
    "m3b0": SmoothConfig(mode=3),
    "m2b1": SmoothConfig(mode=2, binning=True),
    "m2b0h": SmoothConfig(mode=2),
}


@pytest.mark.parametrize("tag", list(_CFGS))
@pytest.mark.parametrize("dataset", ["example", "example_r1", "synth_var"])
def test_golden_byte_equality(dataset, tag):
    batch = read_fastq(golden_path(f"{dataset}.in.fastq"))
    out, _ = smooth_fastq(batch, _CFGS[tag], device="cpu")
    got = format_fastq(out) if tag == "m2b0h" else format_fastq(out, headers=None)
    with open(golden_path(f"{dataset}.{tag}.fq"), "rb") as f:
        assert got == f.read()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matches_jax_engine_on_random_batches(seed):
    rng = np.random.default_rng(200 + seed)
    batch = tiny_batch(rng, n_reads=60, min_len=8, max_len=24, n_frac=0.03)
    cfg = SmoothConfig(mode=seed, k=4, min_cluster=3, binning=seed == 2)
    out, stats = smooth_fastq(batch, cfg, device="cpu")
    want, want_stats = jax_smooth_fastq(batch, cfg)
    assert stats == want_stats
    assert stats["num_clust"] > 0
    w = out.max_len
    assert np.array_equal(out.lengths, want.lengths)
    assert np.array_equal(out.seqs, want.seqs[:, :w])
    assert np.array_equal(out.quals, want.quals[:, :w])
    assert format_fastq(out) == format_fastq(want)

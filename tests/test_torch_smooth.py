"""The port's smoother and inverter against the JAX package on the same EBWT.

The JAX build's arrays are carried into torch tensors with
convert.ebwt_from_numpy, so each comparison isolates one stage.  Outputs and
every counter must be exactly equal.
"""

import numpy as np
import pytest
import torch

import jax

from bfqzip_tpu.config import SmoothConfig
from bfqzip_tpu.io.fastq import read_fastq
from bfqzip_tpu.ops.invert import illumina_bin_jax
from bfqzip_tpu.ops.invert import invert_via_sa as jax_invert_via_sa
from bfqzip_tpu.ops.smooth import smooth as jax_smooth
from bfqzip_tpu.ops.suffix import build_ebwt as jbuild
from bfqzip_tpu_torch.convert import ebwt_from_numpy
from bfqzip_tpu_torch.ops import invert as tinvert
from bfqzip_tpu_torch.ops import smooth as tsmooth

from conftest import golden_path
from tests_util import tiny_batch
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

FIELDS = ("bwt", "qs", "lcp", "sa", "text", "n", "pre")


def _jax_ebwt(batch):
    return jbuild(np.asarray(batch.seqs), np.asarray(batch.quals), np.asarray(batch.lengths))


def _assert_smooth_equal(jeb, cfg):
    want = jax.jit(lambda e: jax_smooth(e, cfg, pre=e.pre))(jeb)
    teb = ebwt_from_numpy({f: np.asarray(getattr(jeb, f)) for f in FIELDS}, "cpu")
    got = tsmooth.smooth(teb, cfg, pre=teb.pre)
    assert np.array_equal(got.bwt_sub.numpy(), np.asarray(want.bwt_sub))
    assert np.array_equal(got.qs.numpy(), np.asarray(want.qs))
    assert set(got.stats) == set(want.stats)
    for k in want.stats:
        assert int(got.stats[k]) == int(want.stats[k]), k
    return teb, got, want


@pytest.mark.parametrize("dataset", ["example", "synth_var"])
@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_smooth_matches_jax_on_goldens(dataset, mode):
    batch = read_fastq(golden_path(f"{dataset}.in.fastq"))
    _, got, _ = _assert_smooth_equal(_jax_ebwt(batch), SmoothConfig(mode=mode))
    if dataset == "example":
        assert int(got.stats["num_clust"]) > 0 and int(got.stats["qs_smoothed"]) > 0


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_smooth_matches_jax_random_small_clusters(mode):
    rng = np.random.default_rng(40 + mode)
    cfg = SmoothConfig(k=4, min_cluster=3, mode=mode)
    for _ in range(2):
        batch = tiny_batch(rng, n_reads=60, min_len=8, max_len=24, n_frac=0.03)
        _, got, _ = _assert_smooth_equal(_jax_ebwt(batch), cfg)
        assert int(got.stats["num_clust"]) > 0


@pytest.mark.parametrize("binning", [False, True])
def test_invert_via_sa_matches_jax(binning):
    batch = read_fastq(golden_path("example.in.fastq"))
    cfg = SmoothConfig(binning=binning)
    jeb = _jax_ebwt(batch)
    teb, got, want = _assert_smooth_equal(jeb, cfg)
    n_reads, width = batch.seqs.shape
    jinv = jax_invert_via_sa(jeb.sa, jeb.bwt, want.bwt_sub, want.qs, jeb.n, n_reads, width,
                             binning=binning)
    tinv = tinvert.invert_via_sa(teb.sa, teb.bwt, got.bwt_sub, got.qs, teb.n, n_reads, width,
                                 binning=binning)
    for f in ("seqs", "quals", "lengths"):
        assert np.array_equal(getattr(tinv, f).numpy(), np.asarray(getattr(jinv, f))), f


def test_illumina_bin_matches_jax():
    qs = np.arange(256, dtype=np.uint8)
    want = np.asarray(illumina_bin_jax(qs))
    assert np.array_equal(tinvert.illumina_bin(torch.as_tensor(qs)).numpy(), want)


def test_mode1_thresholds_match_direct_rounding():
    """The host threshold table reproduces floor(-10*log10(avg) + 0.5) + 33."""
    import math

    rng = np.random.default_rng(9)
    avg = np.concatenate([10.0 ** -rng.uniform(0, 6, 5000), [1.0, 1e-300, 0.0]])
    _, thr = tsmooth._m1_tables()
    got = tsmooth._M1_VMIN + (thr.size - np.searchsorted(thr, avg, side="right")) + 33
    want = [math.floor(-10.0 * math.log10(max(a, 1e-300)) + 0.5) + 33 for a in avg]
    assert np.array_equal(np.clip(got, 0, 255), np.clip(want, 0, 255))

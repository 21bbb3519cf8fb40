"""The port's cached-artifact path against the JAX package: lf_array, the LF
walk `invert`, smooth with pre=None and engine.smooth_arrays_step, on the
golden EBWTs padded to a multiple of 1024 as pipeline.step3_smooth pads them
(bwt=SIGMA, qs=0, lcp=0).  Every array and counter must be exactly equal."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bfqzip_tpu import alphabet
from bfqzip_tpu.config import SmoothConfig
from bfqzip_tpu.engine import smooth_arrays_step as jax_smooth_arrays_step
from bfqzip_tpu.io.fastq import ReadBatch, format_fastq, read_fastq
from bfqzip_tpu.ops.invert import invert as jax_invert
from bfqzip_tpu.ops.rank import lf_array as jax_lf_array
from bfqzip_tpu.ops.smooth import smooth as jax_smooth
from bfqzip_tpu.ops.suffix import EbwtDevice as JaxEbwt
from bfqzip_tpu_torch.convert import batch_to_tensors
from bfqzip_tpu_torch.engine import smooth_arrays_step
from bfqzip_tpu_torch.ops.invert import invert
from bfqzip_tpu_torch.ops.rank import counts, lf_array
from bfqzip_tpu_torch.ops.smooth import smooth
from bfqzip_tpu_torch.ops.suffix import EbwtDevice, build_ebwt

from conftest import golden_path
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

DATASETS = ["example", "example_r1", "synth_var"]
_CFGS = {
    "m0b0": SmoothConfig(mode=0),
    "m1b0": SmoothConfig(mode=1),
    "m2b0": SmoothConfig(mode=2),
    "m3b0": SmoothConfig(mode=3),
    "m2b1": SmoothConfig(mode=2, binning=True),
    "m2b0h": SmoothConfig(mode=2),
}


@functools.lru_cache(maxsize=None)
def _artifacts(dataset):
    """(bwt, qs, lcp) padded to a multiple of 1024, n, n_reads, width, batch."""
    batch = read_fastq(golden_path(f"{dataset}.in.fastq"))
    e = build_ebwt(*batch_to_tensors(batch, "cpu"))
    n = int(e.n)
    pad = -(-n // 1024) * 1024 - n
    bwt = np.pad(e.bwt[:n].numpy(), (0, pad), constant_values=alphabet.SIGMA)
    qs = np.pad(e.qs[:n].numpy(), (0, pad))
    lcp = np.pad(e.lcp[:n].numpy(), (0, pad))
    return bwt, qs, lcp, n, batch.num_reads, batch.max_len, batch


def _valid(n_pad, n):
    return np.arange(n_pad) < n


@pytest.mark.parametrize("dataset", DATASETS)
def test_lf_array_matches_jax(dataset):
    bwt, _, _, n, _, _, _ = _artifacts(dataset)
    valid = _valid(bwt.size, n)
    got = lf_array(torch.as_tensor(bwt), torch.as_tensor(valid))
    want = np.asarray(jax_lf_array(jnp.asarray(bwt), jnp.asarray(valid)))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    # TERM and padding positions map to themselves; the other positions map
    # one to one onto the non-terminator rows [n_reads, n)
    fixed = (bwt == alphabet.TERM) | ~valid
    assert np.array_equal(got.numpy()[fixed], np.flatnonzero(fixed))
    n_reads = _artifacts(dataset)[4]
    assert np.array_equal(np.sort(got.numpy()[~fixed]), np.arange(n_reads, n))
    cnt = counts(torch.as_tensor(bwt), torch.as_tensor(valid)).numpy()
    assert np.array_equal(cnt, np.bincount(bwt[:n], minlength=alphabet.SIGMA))


@pytest.mark.parametrize("binning", [False, True])
@pytest.mark.parametrize("dataset", ["example", "synth_var"])
def test_invert_matches_jax(dataset, binning):
    bwt, qs, _, n, n_reads, width, batch = _artifacts(dataset)
    rng = np.random.default_rng(7)
    # substitute some bases and change some qualities, as smoothing would
    real = (bwt != alphabet.TERM) & _valid(bwt.size, n)
    bwt_sub = np.where(real & (rng.random(bwt.size) < 0.1),
                       rng.integers(1, alphabet.SIGMA, bwt.size), bwt).astype(np.uint8)
    qs2 = np.where(real, rng.integers(35, 75, bwt.size), qs).astype(np.uint8)
    lf = np.array(jax_lf_array(jnp.asarray(bwt), jnp.asarray(_valid(bwt.size, n))))
    got = invert(torch.as_tensor(bwt), torch.as_tensor(bwt_sub), torch.as_tensor(qs2),
                 torch.as_tensor(lf), n_reads, width, binning=binning)
    want = jax_invert(jnp.asarray(bwt), jnp.asarray(bwt_sub), jnp.asarray(qs2),
                      jnp.asarray(lf), n_reads, width, binning=binning)
    assert np.array_equal(got.seqs.numpy(), np.asarray(want.seqs))
    assert np.array_equal(got.quals.numpy(), np.asarray(want.quals))
    assert np.array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    # identity: walking the unsmoothed EBWT gives the input reads back
    ident = invert(torch.as_tensor(bwt), torch.as_tensor(bwt), torch.as_tensor(qs),
                   torch.as_tensor(lf), n_reads, width)
    assert np.array_equal(ident.seqs.numpy(), batch.seqs)
    assert np.array_equal(ident.lengths.numpy(), batch.lengths)
    if not binning:
        assert np.array_equal(ident.quals.numpy(), batch.quals)


@pytest.mark.parametrize("mode", [1, 2])
def test_smooth_without_pre_matches_jax(mode):
    bwt, qs, lcp, n, _, _, _ = _artifacts("example")
    cfg = SmoothConfig(mode=mode)
    t = [torch.as_tensor(a) for a in (bwt, qs, lcp)]
    got = smooth(EbwtDevice(*t, sa=None, text=None, n=torch.tensor(n, dtype=torch.int32)), cfg)
    j = [jnp.asarray(a) for a in (bwt, qs, lcp)]
    jeb = JaxEbwt(*j, sa=jnp.zeros_like(j[2]), text=jnp.zeros_like(j[0]), n=jnp.int32(n))
    want = jax.jit(lambda e: jax_smooth(e, cfg))(jeb)
    assert np.array_equal(got.bwt_sub.numpy(), np.asarray(want.bwt_sub))
    assert np.array_equal(got.qs.numpy(), np.asarray(want.qs))
    assert {k: int(v) for k, v in got.stats.items()} == {k: int(v) for k, v in want.stats.items()}
    assert int(got.stats["modified"]) > 0


def _run_arrays_step(dataset, cfg):
    bwt, qs, lcp, n, n_reads, width, _ = _artifacts(dataset)
    return smooth_arrays_step(torch.as_tensor(bwt), torch.as_tensor(qs), torch.as_tensor(lcp),
                              torch.tensor(n, dtype=torch.int32), n_reads, width, cfg)


@pytest.mark.parametrize("tag", list(_CFGS))
@pytest.mark.parametrize("dataset", DATASETS)
def test_smooth_arrays_step_goldens(dataset, tag):
    inv, _, _, _ = _run_arrays_step(dataset, _CFGS[tag])
    batch = _artifacts(dataset)[-1]
    out = ReadBatch(seqs=inv.seqs.numpy(), quals=inv.quals.numpy(),
                    lengths=inv.lengths.numpy(), headers=batch.headers)
    got = format_fastq(out) if tag == "m2b0h" else format_fastq(out, headers=None)
    with open(golden_path(f"{dataset}.{tag}.fq"), "rb") as f:
        assert got == f.read()


@pytest.mark.parametrize("tag", ["m1b0", "m2b1"])
def test_smooth_arrays_step_matches_jax(tag):
    cfg = _CFGS[tag]
    bwt, qs, lcp, n, n_reads, width, _ = _artifacts("example")
    inv, bwt_sub, qs_new, stats = _run_arrays_step("example", cfg)
    w_inv, w_sub, w_qs, w_stats = jax_smooth_arrays_step(
        jnp.asarray(bwt), jnp.asarray(qs), jnp.asarray(lcp), np.int32(n), n_reads, width, cfg)
    assert np.array_equal(bwt_sub.numpy(), np.asarray(w_sub))
    assert np.array_equal(qs_new.numpy(), np.asarray(w_qs))
    assert {k: int(v) for k, v in stats.items()} == {k: int(v) for k, v in w_stats.items()}
    assert np.array_equal(inv.seqs.numpy(), np.asarray(w_inv.seqs))
    assert np.array_equal(inv.quals.numpy(), np.asarray(w_inv.quals))
    assert np.array_equal(inv.lengths.numpy(), np.asarray(w_inv.lengths))

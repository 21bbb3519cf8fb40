"""The port's smooth_fastq_external on the CPU, on the cases of the JAX
package's tests/test_external.py beyond its five parametrisations: variable
read lengths, the giant-cluster fallback, spill files, long reads through
the doubling build, and 64-bit coordinates.  Each is byte-equal, in outputs
and stats, to bfqzip_tpu.external (its serial-merge route) or to the port's
in-core engine."""

import numpy as np
import pytest
import torch

from bfqzip_tpu import SmoothConfig, alphabet
from bfqzip_tpu.external import smooth_fastq_external as jax_external
from bfqzip_tpu.io.fastq import ReadBatch, format_fastq, read_fastq
from bfqzip_tpu_torch.utils import native
from bfqzip_tpu_torch.engine import smooth_fastq
from bfqzip_tpu_torch.external import smooth_fastq_external
from bfqzip_tpu_torch.ops import cuda_scan

from conftest import golden_path
from tests_util import tiny_batch
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

pytestmark = pytest.mark.skipif(not native.ext_merge_available(), reason="native library not built")


def _assert_same(got, gstats, want, wstats):
    assert np.array_equal(got.lengths, want.lengths)
    assert np.array_equal(np.asarray(got.seqs), np.asarray(want.seqs))
    assert np.array_equal(np.asarray(got.quals), np.asarray(want.quals))
    assert gstats == wstats


def _cmp_jax(monkeypatch, batch, cfg, **kw):
    monkeypatch.setenv("BFQ_EXT_OVERLAP", "0")
    want, wstats = jax_external(batch, cfg, **kw)
    got, gstats = smooth_fastq_external(batch, cfg, device="cpu", **kw)
    _assert_same(got, gstats, want, wstats)
    return gstats


def test_varlen_matches_jax(monkeypatch):
    rng = np.random.default_rng(7)
    batch = tiny_batch(rng, n_reads=80, min_len=16, max_len=24, n_frac=0.03)
    stats = _cmp_jax(monkeypatch, batch, SmoothConfig(k=4, min_cluster=3), _seg_len=301,
                     _reads_per_chunk=13)
    assert stats["modified"] > 0


@pytest.mark.parametrize("mode", [2, 0])
def test_giant_cluster_fallback_matches_jax(monkeypatch, mode):
    """Thousands of identical reads make clusters longer than a segment
    (seg_len > fix_cap = 4096), so phase B re-applies whole segments."""
    rng = np.random.default_rng(21)
    bases = np.array([alphabet.A, alphabet.C, alphabet.G, alphabet.T], dtype=np.uint8)
    n = 6000
    batch = ReadBatch(seqs=np.tile(bases[rng.integers(0, 4, 30)], (n, 1)),
                      quals=(33 + rng.integers(2, 42, (n, 30))).astype(np.uint8),
                      lengths=np.full(n, 30, np.int32))
    _cmp_jax(monkeypatch, batch, SmoothConfig(mode=mode), _seg_len=4200, _reads_per_chunk=977)


@pytest.fixture(scope="module")
def example_jax():
    """The example reads and the JAX out-of-core result at 1500-position
    segments and 17-read chunks (its serial-merge route, spill on)."""
    batch = read_fastq(golden_path("example.in.fastq"), with_headers=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BFQ_EXT_OVERLAP", "0")
        want, wstats = jax_external(batch, SmoothConfig(), _seg_len=1500, _reads_per_chunk=17,
                                    spill=True)
    return batch, want, wstats


def test_spill_matches_jax_and_streams_out_path(example_jax, tmp_path):
    batch, want, wstats = example_jax
    cfg = SmoothConfig()
    rep = {}
    out_fq = str(tmp_path / "sp.fq")
    got, gstats = smooth_fastq_external(batch, cfg, device="cpu", _seg_len=1500, _reads_per_chunk=17,
                                        spill=True, out_path=out_fq, report=rep)
    _assert_same(got, gstats, want, wstats)
    ref_bytes = format_fastq(want)
    assert format_fastq(got) == ref_bytes
    assert open(out_fq, "rb").read() == ref_bytes
    assert (rep["n_chunks"], rep["n_segments"]) == (6, 7)
    for stage in ("chunk_sorts", "merge", "smooth", "emit"):
        assert rep[stage + "_s"] >= 0
        assert rep[stage + "_peak_rss_gb"] > 0


def test_long_reads_tiny_chunks_match_jax(monkeypatch):
    """synth_long (400-600 bp) sorts each chunk with the doubling build."""
    batch = read_fastq(golden_path("synth_long.in.fastq"), with_headers=False)
    assert batch.max_len + 1 > 324
    stats = _cmp_jax(monkeypatch, batch, SmoothConfig(), _seg_len=3001, _reads_per_chunk=23)
    assert stats["num_clust"] > 0


def test_sa64_route_matches_jax_int32_route(example_jax, monkeypatch):
    """BFQ_EXT_SA64=1 forces 64-bit suffix positions and int64 segment
    coordinates through the port; the result is the JAX int32 route's."""
    batch, want, wstats = example_jax
    monkeypatch.setenv("BFQ_EXT_SA64", "1")
    got, gstats = smooth_fastq_external(batch, SmoothConfig(), device="cpu", _seg_len=1500,
                                        _reads_per_chunk=17, spill=True)
    _assert_same(got, gstats, want, wstats)


@pytest.mark.parametrize("seed", [0, 1])
def test_external_matches_port_in_core(seed):
    """Reads under 255 bp: the 1-byte merge LCP never saturates, so the
    out-of-core output is the in-core engine's."""
    rng = np.random.default_rng(500 + seed)
    batch = tiny_batch(rng, n_reads=150, min_len=20, max_len=40, n_frac=0.02)
    cfg = SmoothConfig(mode=2 + seed, k=5, min_cluster=3, binning=seed == 1)
    want, wstats = smooth_fastq(batch, cfg, device="cpu")
    got, gstats = smooth_fastq_external(batch, cfg, device="cpu", _seg_len=523, _reads_per_chunk=31)
    w = want.max_len
    assert np.array_equal(got.seqs[:, :w], want.seqs) and np.array_equal(got.quals[:, :w], want.quals)
    assert gstats == wstats and gstats["num_clust"] > 0


def test_cpu_run_launches_no_kernel_and_needs_native(monkeypatch):
    monkeypatch.setattr(cuda_scan, "launches", 0)
    batch = read_fastq(golden_path("example.in.fastq"), with_headers=False)
    smooth_fastq_external(batch, SmoothConfig(), device="cpu", _seg_len=2000, _reads_per_chunk=40)
    assert cuda_scan.launches == 0
    monkeypatch.setattr(native, "ext_merge_available", lambda: False)
    with pytest.raises(RuntimeError, match="native"):
        smooth_fastq_external(batch, SmoothConfig(), device="cpu")
    monkeypatch.undo()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        smooth_fastq_external(batch, SmoothConfig())

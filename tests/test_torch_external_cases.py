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


@pytest.mark.parametrize("overlap", ["1", "0"])
def test_spill_out_path_overlap_on_and_off_match_jax(example_jax, tmp_path, monkeypatch, overlap):
    """Spill files and a streamed out_path, with the merge overlapped and
    serial: both give the JAX serial route's bytes and stats."""
    batch, want, wstats = example_jax
    monkeypatch.setenv("BFQ_EXT_OVERLAP", overlap)
    rep = {}
    out_fq = str(tmp_path / "sp.fq")
    got, gstats = smooth_fastq_external(batch, SmoothConfig(), device="cpu", _seg_len=1500,
                                        _reads_per_chunk=17, spill=True, out_path=out_fq, report=rep)
    _assert_same(got, gstats, want, wstats)
    with open(out_fq, "rb") as f:
        assert f.read() == format_fastq(want)
    assert rep["overlap"] == (overlap == "1")


@pytest.mark.parametrize("overlap", ["1", "0"])
def test_sa64_overlap_on_and_off_match_jax(example_jax, monkeypatch, overlap):
    batch, want, wstats = example_jax
    monkeypatch.setenv("BFQ_EXT_SA64", "1")
    monkeypatch.setenv("BFQ_EXT_OVERLAP", overlap)
    got, gstats = smooth_fastq_external(batch, SmoothConfig(), device="cpu", _seg_len=1500,
                                        _reads_per_chunk=17, spill=True)
    _assert_same(got, gstats, want, wstats)


@pytest.mark.parametrize("threads,seg", [("1", 257), ("2", 401), ("8", 1024)])
def test_tiny_segments_wait_on_a_multi_range_prefix(example_jax, monkeypatch, threads, seg):
    """Tiny segments over a merge of several ranges: before each segment the
    smoother waits until the merged prefix covers the segment and its halo,
    and the result is the JAX serial route's (whose segment size does not
    change its output)."""
    from bfqzip_tpu_torch import external

    batch, want, wstats = example_jax
    monkeypatch.setenv("BFQ_EXT_THREADS", threads)
    monkeypatch.delenv("BFQ_EXT_OVERLAP", raising=False)
    waits, wait = [], external._Merge.wait

    def recording(self, pos):
        wait(self, pos)
        waits.append((pos, self.handle.merged_prefix(), self.handle.total))

    monkeypatch.setattr(external._Merge, "wait", recording)
    rep = {}
    got, gstats = smooth_fastq_external(batch, SmoothConfig(), device="cpu", _seg_len=seg,
                                        _reads_per_chunk=17, report=rep)
    _assert_same(got, gstats, want, wstats)
    assert rep["n_segments"] == len(waits) > 5
    halo = SmoothConfig().min_cluster + 4
    for s, (pos, prefix, total) in enumerate(waits):
        assert pos == min((s + 1) * seg + halo, total)
        assert prefix >= pos


def test_smoother_error_joins_the_merge_and_closes_the_spill(monkeypatch, tmp_path):
    """A stage that raises while the merge runs: the error reaches the
    caller, the merge thread has ended, and the spill directory is gone."""
    from bfqzip_tpu_torch import external

    monkeypatch.setenv("BFQ_SPILL_DIR", str(tmp_path))
    monkeypatch.setenv("BFQ_EXT_THREADS", "1")
    handles, start = [], native.ext_merge_async

    def capture(*args, **kwargs):
        handles.append(start(*args, **kwargs))
        return handles[-1]

    def broken(*args, **kwargs):
        raise ValueError("smoother failed")

    monkeypatch.setattr(native, "ext_merge_async", capture)
    monkeypatch.setattr(external, "_part1_segment", broken)
    batch = read_fastq(golden_path("example.in.fastq"), with_headers=False)
    with pytest.raises(ValueError, match="smoother failed"):
        smooth_fastq_external(batch, SmoothConfig(), device="cpu", _seg_len=257, _reads_per_chunk=17,
                              spill=True)
    assert len(handles) == 1 and handles[0].finished(0)
    assert handles[0].join() == handles[0].total
    assert list(tmp_path.iterdir()) == []


def test_merge_error_raises_in_the_caller(monkeypatch, tmp_path):
    """A merge that fails (here: a progress step that is no power of two,
    rc -6) raises in the caller's thread, and the spill is closed."""
    monkeypatch.setenv("BFQ_SPILL_DIR", str(tmp_path))
    start = native.ext_merge_async
    monkeypatch.setattr(native, "ext_merge_async", lambda *a, **k: start(*a, **k, step=3))
    batch = read_fastq(golden_path("example.in.fastq"), with_headers=False)
    with pytest.raises(RuntimeError, match="rc=-6"):
        smooth_fastq_external(batch, SmoothConfig(), device="cpu", _seg_len=1500, _reads_per_chunk=17,
                              spill=True)
    assert list(tmp_path.iterdir()) == []


def test_spill_projection_counts_the_packed_output(monkeypatch, tmp_path):
    """The up-front disk check counts 21 B per padded position (19 for the
    merge and 2 for the packed output): a disk with 20 B/pos free falls
    back to host arrays, one with 21 keeps the spill files."""
    import collections
    import shutil

    from bfqzip_tpu_torch import external
    from bfqzip_tpu_torch.io.spill import Spill

    usage = collections.namedtuple("usage", "total used free")
    n_pad = 1000
    for per_pos, spills in ((20, False), (21, True)):
        monkeypatch.setattr(shutil, "disk_usage", lambda _, f=per_pos * n_pad: usage(0, 0, f))
        sp, own = external._resolve_spill(Spill(dir=str(tmp_path)), n_pad)
        assert (sp is not None) == spills and not own

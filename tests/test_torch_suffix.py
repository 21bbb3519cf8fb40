"""The port's EBWT builds (flat and prefix doubling) against the JAX builds
and the numpy model."""

import numpy as np
import pytest

from bfqzip_tpu import ref_golden
from bfqzip_tpu.io.fastq import ReadBatch, read_fastq
from bfqzip_tpu.ops.suffix import _build_ebwt_doubling, _build_ebwt_flat
from bfqzip_tpu_torch.convert import batch_to_tensors, ebwt_to_numpy
from bfqzip_tpu_torch.ops import suffix as tsuffix
from bfqzip_tpu_torch.ops.suffix import build_ebwt

from conftest import golden_path
from tests_util import tiny_batch
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

FIELDS = ("bwt", "qs", "lcp", "sa", "text", "n", "pre")


def _assert_same_as_jax(batch):
    jx = _build_ebwt_flat(np.asarray(batch.seqs), np.asarray(batch.quals),
                          np.asarray(batch.lengths))
    got = ebwt_to_numpy(build_ebwt(*batch_to_tensors(batch, "cpu")))
    for f in FIELDS:
        want = np.asarray(getattr(jx, f))
        assert got[f].dtype == want.dtype, f
        assert np.array_equal(got[f], want), f
    return got


def _with_dummy_rows(batch, rows, cols):
    n, w = batch.seqs.shape
    seqs = np.zeros((n + rows, w + cols), np.uint8)
    quals = np.zeros((n + rows, w + cols), np.uint8)
    seqs[:n, :w], quals[:n, :w] = batch.seqs, batch.quals
    lengths = np.concatenate([batch.lengths, np.full(rows, -1, np.int32)])
    # interleave the dummies with the real rows, which keep their order
    is_dummy = np.zeros(n + rows, bool)
    is_dummy[np.random.default_rng(0).choice(n + rows, rows, replace=False)] = True
    order = np.empty(n + rows, np.int64)
    order[~is_dummy] = np.arange(n)
    order[is_dummy] = np.arange(n, n + rows)
    return ReadBatch(seqs=seqs[order], quals=quals[order], lengths=lengths[order])


@pytest.mark.parametrize("dataset", ["example", "example_r1", "synth_var"])
def test_build_matches_jax_and_numpy_model(dataset):
    batch = read_fastq(golden_path(f"{dataset}.in.fastq"))
    got = _assert_same_as_jax(batch)
    ref = ref_golden.build_ebwt(batch)
    n = int(got["n"])
    assert n == ref.bwt.size
    assert np.array_equal(got["bwt"][:n], ref.bwt)
    assert np.array_equal(got["qs"][:n], ref.qs)
    assert np.array_equal(got["lcp"][:n], ref.lcp)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_build_random_tiny_with_ns_and_dummy_rows(seed):
    rng = np.random.default_rng(100 + seed)
    batch = tiny_batch(rng, n_reads=37, min_len=1, max_len=30, n_frac=0.1)
    _assert_same_as_jax(batch)
    # length -1 dummy rows (io.fastq.pad_batch's meaning) and a wider grid stay inert
    padded = _with_dummy_rows(batch, rows=6, cols=5)
    got = _assert_same_as_jax(padded)
    plain = ebwt_to_numpy(build_ebwt(*batch_to_tensors(batch, "cpu")))
    n = int(plain["n"])
    assert int(got["n"]) == n
    for f in ("bwt", "qs", "lcp"):
        assert np.array_equal(got[f][:n], plain[f][:n]), f
    # pre is read only where the BWT holds a base: at a read's first suffix
    # it points into the previous row's padding, which the grid width moves
    used = plain["bwt"][:n] != 0
    assert np.array_equal(got["pre"][:n][used], plain["pre"][:n][used])


def _assert_doubling_same_as_jax(batch, direct=False):
    """Every array of the port's doubling build equals the JAX one's; pre
    stays None, as in JAX."""
    args = (np.asarray(batch.seqs), np.asarray(batch.quals), np.asarray(batch.lengths))
    jx = _build_ebwt_doubling(*args)
    build = tsuffix._build_ebwt_doubling if direct else build_ebwt
    ebwt = build(*batch_to_tensors(batch, "cpu"))
    assert ebwt.pre is None
    got = {f: getattr(ebwt, f).numpy() for f in FIELDS if f != "pre"}
    for f, v in got.items():
        want = np.asarray(getattr(jx, f))
        assert v.dtype == want.dtype, f
        assert np.array_equal(v, want), f
    return got


@pytest.mark.parametrize("dataset, direct", [("synth_long", False), ("example", True),
                                             ("synth_var", True)])
def test_doubling_build_matches_jax_and_numpy_model(dataset, direct):
    """synth_long (400-600 bp) goes through build_ebwt's dispatch; the short
    goldens call the doubling path directly."""
    batch = read_fastq(golden_path(f"{dataset}.in.fastq"))
    got = _assert_doubling_same_as_jax(batch, direct)
    ref = ref_golden.build_ebwt(batch)
    n = int(got["n"])
    assert n == ref.bwt.size
    for f in ("bwt", "qs", "lcp"):
        assert np.array_equal(got[f][:n], getattr(ref, f)), f


def test_dispatch_at_the_flat_window_limit():
    """width + 1 == 324 is the widest flat window, as in the JAX dispatch;
    one more column takes the doubling build."""
    rng = np.random.default_rng(9)
    full = tiny_batch(rng, n_reads=12, min_len=324, max_len=324, n_frac=0.01)
    lengths = rng.integers(250, 325, 12).astype(np.int32)
    lengths[0] = 324
    keep = np.arange(324)[None, :] < lengths[:, None]
    batch = ReadBatch(seqs=np.where(keep, full.seqs, 0).astype(np.uint8),
                      quals=np.where(keep, full.quals, 0).astype(np.uint8), lengths=lengths)
    at_limit = ReadBatch(seqs=batch.seqs[:, :323], quals=batch.quals[:, :323],
                         lengths=np.minimum(batch.lengths, 323))
    assert build_ebwt(*batch_to_tensors(at_limit, "cpu")).pre is not None
    _assert_same_as_jax(at_limit)
    assert batch.seqs.shape[1] == 324
    _assert_doubling_same_as_jax(batch)


@pytest.mark.parametrize("seed", [0, 1])
def test_doubling_repetitive_long_reads(seed):
    """Long reads cut from a short genome, with exact duplicates and ties
    that last into the late doubling rounds: SA order and the lifted LCP
    against JAX and the numpy model."""
    rng = np.random.default_rng(700 + seed)
    genome = rng.integers(1, 5, 420).astype(np.uint8)
    n_reads, width = 30, 340
    starts = rng.integers(0, 40, n_reads)
    lengths = rng.integers(300, width + 1, n_reads).astype(np.int32)
    lengths[:5], starts[:5] = width, 7  # exact duplicates
    cols = np.arange(width)
    seqs = np.where(cols[None, :] < lengths[:, None], genome[starts[:, None] + cols[None, :]], 0)
    quals = np.where(seqs > 0, rng.integers(35, 75, seqs.shape), 0)
    batch = ReadBatch(seqs=seqs.astype(np.uint8), quals=quals.astype(np.uint8), lengths=lengths)
    got = _assert_doubling_same_as_jax(batch)
    ref = ref_golden.build_ebwt(batch)
    n = int(got["n"])
    assert np.array_equal(got["lcp"][:n], ref.lcp)
    assert got["lcp"].max() >= 300  # pairs equal across every doubling span


@pytest.mark.parametrize("seed", [0, 1])
def test_build_repetitive_reads(seed):
    """Reads cut from a short genome: duplicates, and shared prefixes that
    cross several 24-digit key words."""
    rng = np.random.default_rng(300 + seed)
    genome = rng.integers(1, 6, 90).astype(np.uint8)  # codes A..T, with N
    genome = np.where(genome == 4, 1, genome).astype(np.uint8)
    n_reads, width = 40, 75
    starts = rng.integers(0, 15, n_reads)
    lengths = rng.integers(50, width + 1, n_reads).astype(np.int32)
    lengths[:6] = width  # exact duplicates among these
    starts[:6] = 3
    cols = np.arange(width)
    seqs = np.where(cols[None, :] < lengths[:, None], genome[starts[:, None] + cols[None, :]], 0)
    quals = np.where(seqs > 0, rng.integers(35, 75, seqs.shape), 0)
    batch = ReadBatch(seqs=seqs.astype(np.uint8), quals=quals.astype(np.uint8), lengths=lengths)
    got = _assert_same_as_jax(batch)
    ref = ref_golden.build_ebwt(batch)
    n = int(got["n"])
    assert np.array_equal(got["lcp"][:n], ref.lcp)
    assert got["lcp"].max() >= 48  # pairs that agree beyond two key words

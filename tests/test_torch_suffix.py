"""The port's flat EBWT build against the JAX build and the numpy model."""

import numpy as np
import pytest
import torch

from bfqzip_tpu import ref_golden
from bfqzip_tpu.io.fastq import ReadBatch, read_fastq
from bfqzip_tpu.ops.suffix import _build_ebwt_flat
from bfqzip_tpu_torch.convert import batch_to_tensors, ebwt_to_numpy
from bfqzip_tpu_torch.ops.suffix import build_ebwt

from conftest import golden_path
from tests_util import tiny_batch

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


def test_long_reads_raise():
    seqs = torch.ones((2, 324), dtype=torch.uint8)
    with pytest.raises(NotImplementedError, match="doubling"):
        build_ebwt(seqs, seqs, torch.tensor([324, 300], dtype=torch.int32))
    # the widest flat window (width + 1 == 324, as in the JAX dispatch) still builds
    seqs = torch.ones((1, 323), dtype=torch.uint8)
    ebwt = build_ebwt(seqs, seqs + 40, torch.tensor([323], dtype=torch.int32))
    assert int(ebwt.n) == 324


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

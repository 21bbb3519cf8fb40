"""The port's process groups against the JAX package's mesh: DistScanOps at
d = 4 against JAX's DistScanOps under shard_map on 4 of the 8 virtual CPU
devices, sharded_sort at d = 4 and 8, block_smooth_fastq with padding
against JAX's block_smooth_fastq, the two-rank multihost feed, a failing
rank, and the refusal of more NCCL ranks than cards.

Each world is spawned once per module (gloo ranks on the CPU, one torch
thread each, a FileStore under the test's temporary directory) and runs
every case of its kind; the tests compare the results."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from bfqzip_tpu.config import SmoothConfig as JaxSmoothConfig
from bfqzip_tpu.parallel import block_smooth_fastq as jax_block_smooth_fastq
from bfqzip_tpu.parallel import make_mesh
from bfqzip_tpu.parallel.dist_scan import DistScanOps as JaxDistScanOps
from bfqzip_tpu_torch.config import SmoothConfig
from bfqzip_tpu_torch.engine import smooth_fastq
from bfqzip_tpu_torch.io.fastq import ReadBatch, read_fastq
from bfqzip_tpu_torch.parallel import block_smooth_fastq, mesh, smooth_fastq_sharded

import torch_ranks
from conftest import golden_path
from tests_util import tiny_batch
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

D = 4
TIMEOUT_S = 120


def spawn(fn, world, tmp_path_factory, *args):
    work = str(tmp_path_factory.mktemp("ranks"))
    return mesh.spawn(fn, world, "cpu", work, args=args, timeout_s=TIMEOUT_S)


def _scan_inputs():
    rng = np.random.default_rng(0)
    n = 64 * D
    return {
        "x": rng.integers(0, 100, n).astype(np.int32),
        "xc": rng.integers(0, 100, (5, n)).astype(np.int32),
        # dyadic values: every order of summation gives the same float64 sums
        "xf": rng.integers(0, 1000, n) / 1024.0,
        "flag": rng.random(n) < 0.1,
        "mark": rng.random(n) < 0.05,
    }


@pytest.fixture(scope="module")
def scans(tmp_path_factory):
    arrays = _scan_inputs()
    per_rank = spawn(torch_ranks.dist_scans, D, tmp_path_factory, arrays)
    return arrays, per_rank


def _jax_scan(name, arrays):
    """JAX's DistScanOps on the same case, under shard_map on a (1, D) mesh."""
    method, names, extra = torch_ranks.SCAN_CASES[name]
    ops = JaxDistScanOps("seq", D)
    combine = {"add": jnp.add, "max": jnp.maximum}
    if method == "seg_scan":
        extra = (combine[extra[0]], extra[1])
    if method == "iota":
        names, body = ("x",), lambda a: ops.iota(a.shape[0])
    elif method == "sum":
        body = lambda a: ops.sum(a)[None]  # noqa: E731
    else:
        body = lambda *a: getattr(ops, method)(*a, *extra)  # noqa: E731
    specs = tuple(P(None, "seq") if arrays[k].ndim == 2 else P("seq") for k in names)
    out_spec = P(None, "seq") if name == "seg_cumsum_c5" else P("seq")
    f = jax.shard_map(body, mesh=make_mesh((1, D)), in_specs=specs, out_specs=out_spec)
    return np.asarray(jax.jit(f)(*(jnp.asarray(arrays[k]) for k in names)))


@pytest.mark.parametrize("name", list(torch_ranks.SCAN_CASES))
def test_dist_scan_matches_jax(scans, name):
    arrays, per_rank = scans
    parts = [r[name] for r in per_rank]
    want = _jax_scan(name, arrays)
    if name == "sum":
        assert all(int(p) == int(want[0]) == int(arrays["x"].sum()) for p in parts)
        return
    got = np.concatenate(parts, axis=-1)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("world", [4, 8])
def test_sharded_sort(tmp_path_factory, world):
    rng = np.random.default_rng(7)
    x = rng.integers(0, 1 << 24, size=world * 8192).astype(np.int32)
    per_rank = spawn(torch_ranks.sorts, world, tmp_path_factory, x)
    assert sum(o for _, _, o in per_rank) == 0
    assert sum(c for _, c, _ in per_rank) == x.size
    vals = np.concatenate([b[:c] for b, c, _ in per_rank])
    assert np.array_equal(vals, np.sort(x))


def test_block_smooth_fastq_with_padding(tmp_path):
    """50 reads over 4 blocks: 2 dummy reads fill the last; reads, lengths
    and stats equal JAX's block_smooth_fastq on a (4, 1) mesh."""
    rng = np.random.default_rng(5)
    jb = tiny_batch(rng, n_reads=50, min_len=10, max_len=20)
    cfg = dict(k=4, min_cluster=3)
    want, want_stats = jax_block_smooth_fastq(jb, JaxSmoothConfig(**cfg), make_mesh((4, 1)),
                                              axes=("data",))
    batch = ReadBatch(seqs=jb.seqs, quals=jb.quals, lengths=jb.lengths, headers=jb.headers)
    got, stats = block_smooth_fastq(batch, SmoothConfig(**cfg), 4, device="cpu",
                                    work_dir=str(tmp_path))
    assert np.array_equal(got.lengths, jb.lengths) and got.num_reads == 50
    assert np.array_equal(got.seqs, want.seqs) and np.array_equal(got.quals, want.quals)
    assert stats == want_stats and stats["num_clust"] > 0


def test_two_rank_multihost_feed(tmp_path_factory):
    """Two ranks each feed half of example.in.fastq; their halves joined
    are the single-process smooth_fastq, and both see its stats."""
    batch = read_fastq(golden_path("example.in.fastq"))
    want, want_stats = smooth_fastq(batch, SmoothConfig(), device="cpu")
    arrays = (batch.seqs, batch.quals, batch.lengths)
    per_rank = spawn(torch_ranks.pipelines, 2, tmp_path_factory, [(arrays, {}, 2.5)])
    seqs = np.concatenate([r[0][0] for r in per_rank])
    quals = np.concatenate([r[0][1] for r in per_rank])
    lengths = np.concatenate([r[0][2] for r in per_rank])
    w = int(want.lengths.max())
    assert np.array_equal(lengths, want.lengths)
    assert np.array_equal(seqs[:, :w], want.seqs[:, :w])
    assert np.array_equal(quals[:, :w], want.quals[:, :w])
    assert per_rank[0][0][3] == per_rank[1][0][3] == want_stats


def test_a_failing_rank_fails_the_world(tmp_path):
    """A rank that raises is reported with its traceback, and the rank left
    waiting in a collective is stopped."""
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed(.|\n)*rank 1 gives up"):
        mesh.spawn(torch_ranks.fail_on_rank_1, 2, "cpu", str(tmp_path), timeout_s=TIMEOUT_S)
    assert os.listdir(tmp_path) == []  # the rendezvous file is gone


def test_more_nccl_ranks_than_cards_raise(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 ranks need 2 CUDA devices.*device_count\\(\\) is 1"):
        mesh.check_world(2, "cuda")
    batch = read_fastq(golden_path("example.in.fastq"))
    with pytest.raises(ValueError, match="device_count"):
        block_smooth_fastq(batch, SmoothConfig(), 2, device="cuda", work_dir=str(tmp_path))
    with pytest.raises(ValueError, match="device_count"):
        smooth_fastq_sharded(batch, SmoothConfig(), 2, device="cuda", work_dir=str(tmp_path))
    assert os.listdir(tmp_path) == []
    mesh.check_world(2, "cuda", backend="gloo")  # ranks sharing a card, asked for
    mesh.check_world(8, "cpu")
    assert mesh.factor2(8) == (4, 2) and mesh.factor2(7) == (7, 1)

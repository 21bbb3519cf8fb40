"""The port's sequence-sharded pipeline (smooth_fastq_sharded over 4 gloo
ranks) against the JAX package's smooth_fastq_sharded on a (1, 4) mesh of
the virtual CPU devices and against the port's single-device smooth_fastq:
reads and stats equal for modes 2 and 0 on example.in.fastq, and for a
forced bucket overflow whose retry gives the same bytes.  Modes 3 (with
binning) and 1 and variable-length reads are in
test_torch_parallel_modes.py.

The world is spawned once per module and runs every case; content is
compared up to each read's length (the sharded path returns the raw width)."""

import numpy as np
import pytest

from bfqzip_tpu.config import SmoothConfig as JaxSmoothConfig
from bfqzip_tpu.io.fastq import read_fastq as jax_read_fastq
from bfqzip_tpu.parallel import make_mesh
from bfqzip_tpu.parallel.global_pipeline import smooth_fastq_sharded as jax_smooth_fastq_sharded
from bfqzip_tpu_torch.config import SmoothConfig
from bfqzip_tpu_torch.engine import smooth_fastq
from bfqzip_tpu_torch.io.fastq import ReadBatch
from bfqzip_tpu_torch.parallel import mesh

import torch_ranks
from conftest import golden_path
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

D = 4
TIMEOUT_S = 120


def example():
    return jax_read_fastq(golden_path("example.in.fastq"))


# name -> (batch, SmoothConfig fields, capacity factor)
CASES = {
    "m2": (example, dict(mode=2), 2.5),
    "m0": (example, dict(mode=0), 2.5),
    "m2_retry": (example, dict(mode=2), 0.5),  # the first attempt overflows
}


def run_world(cases, tmp_path_factory):
    """{name: (seqs, quals, lengths, stats, report)} from one world of D ranks."""
    arrays = {name: ((b.seqs, b.quals, b.lengths.astype(np.int32)), cfg, cf)
              for name, (b, cfg, cf) in cases.items()}
    work = str(tmp_path_factory.mktemp("pipeline"))
    return mesh.spawn(torch_ranks.smooths, D, "cpu", work, args=(arrays,), timeout_s=TIMEOUT_S)[0]


def assert_batches_equal(seqs, quals, lengths, want):
    """Content equality up to each read's length."""
    assert np.array_equal(lengths, want.lengths)
    w = int(want.lengths.max())
    assert np.array_equal(seqs[:, :w], want.seqs[:, :w])
    assert np.array_equal(quals[:, :w], want.quals[:, :w])


def check_case(results, cases, name):
    make, cfg, _ = cases[name]
    jb = make()
    seqs, quals, lengths, stats, report = results[name]
    want, want_stats = jax_smooth_fastq_sharded(jb, JaxSmoothConfig(**cfg), make_mesh((1, D)))
    assert_batches_equal(seqs, quals, lengths, want)
    assert stats == want_stats
    batch = ReadBatch(seqs=jb.seqs, quals=jb.quals, lengths=jb.lengths)
    single, single_stats = smooth_fastq(batch, SmoothConfig(**cfg), device="cpu")
    assert_batches_equal(seqs, quals, lengths, single)
    assert stats == single_stats and stats["num_clust"] > 0
    return report


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_world({k: (make(), cfg, cf) for k, (make, cfg, cf) in CASES.items()},
                     tmp_path_factory)


@pytest.mark.parametrize("name", ["m2", "m0"])
def test_sharded_pipeline_matches_jax_and_single_device(results, name):
    report = check_case(results, CASES, name)
    assert [a["overflow"] for a in report["attempts"]] == [0]
    assert report["staged_bytes"] == 0 < report["sent_bytes"]  # gloo on CPU tensors: no staging


def test_overflow_retry_gives_the_same_bytes(results):
    report = check_case(results, CASES, "m2_retry")
    overflows = [a["overflow"] for a in report["attempts"]]
    assert len(overflows) > 1 and overflows[0] > 0 and overflows[-1] == 0
    got, want = results["m2_retry"], results["m2"]
    for a, b in zip(got[:3], want[:3]):
        assert np.array_equal(a, b)

"""The port's sequence-sharded EBWT (build_ebwt_sharded over gloo ranks) at
d = 2 and 4 against the JAX package's build_ebwt_sharded on a (1, d) mesh of
the virtual CPU devices and against the NumPy oracle ref_golden, on every
case of tests/test_global_ebwt.py: tiny random reads, example.in.fastq, a
read count no rank count divides, reads past the flat body (prefix
doubling), and identical reads whose ties leave a rank empty.  One more
case forces a bucket overflow with a small capacity factor: the retry at
doubled capacity gives the same EBWT.

Each world is spawned once per module and builds every case."""

import numpy as np
import pytest

from bfqzip_tpu import ref_golden
from bfqzip_tpu.io.fastq import ReadBatch, read_fastq
from bfqzip_tpu.parallel import make_mesh
from bfqzip_tpu.parallel.global_ebwt import build_ebwt_sharded as jax_build_ebwt_sharded
from bfqzip_tpu_torch.parallel import mesh

import torch_ranks
from conftest import golden_path
from tests_util import tiny_batch
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

WORLDS = (2, 4)
TIMEOUT_S = 120
TIGHT = 0.5  # a capacity factor below one rank's share: the first attempt overflows


def _ties():
    base = tiny_batch(np.random.default_rng(12), n_reads=4, min_len=30, max_len=30, n_frac=0.0)
    return ReadBatch(seqs=np.tile(base.seqs, (8, 1)), quals=np.tile(base.quals, (8, 1)),
                     lengths=np.tile(base.lengths, 8).astype(np.int32))


CASES = {
    "tiny": lambda: tiny_batch(np.random.default_rng(9), n_reads=64, min_len=20, max_len=24,
                               n_frac=0.02),
    "example": lambda: read_fastq(golden_path("example.in.fastq")),
    "non_divisible": lambda: tiny_batch(np.random.default_rng(1), n_reads=30, min_len=10,
                                        max_len=12),
    "doubling": lambda: tiny_batch(np.random.default_rng(11), n_reads=24, min_len=122,
                                   max_len=140, n_frac=0.01),
    "ties": _ties,
}
BATCHES = {name: make() for name, make in CASES.items()}
CAPACITY = dict.fromkeys(CASES, 2.5) | {"retry": TIGHT}
BATCHES["retry"] = BATCHES["example"]


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """{d: {case: the port's ShardedEbwt fields}}, one spawned world per d."""
    arrays = {name: (b.seqs, b.quals, b.lengths.astype(np.int32), CAPACITY[name])
              for name, b in BATCHES.items()}
    out = {}
    for d in WORLDS:
        work = str(tmp_path_factory.mktemp(f"ebwt{d}"))
        out[d] = mesh.spawn(torch_ranks.ebwts, d, "cpu", work, args=(arrays,),
                            timeout_s=TIMEOUT_S)[0]
    return out


@pytest.mark.parametrize("d", WORLDS)
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_ebwt_matches_jax_and_oracle(built, d, case):
    b = BATCHES[case]
    got = built[d][case]
    want = jax_build_ebwt_sharded(b.seqs, b.quals, b.lengths, make_mesh((1, d)), axis="seq")
    for field in ("bwt", "qs", "lcp", "sa"):
        assert np.array_equal(got[field], getattr(want, field)), field
    assert got["n"] == want.n and got["overflow"] == want.overflow == 0
    ref = ref_golden.build_ebwt(b)
    assert got["n"] == ref.bwt.size
    assert np.array_equal(got["bwt"], ref.bwt)
    assert np.array_equal(got["qs"], ref.qs)
    assert np.array_equal(got["lcp"], ref.lcp)


@pytest.mark.parametrize("d", WORLDS)
def test_overflow_retry_gives_the_same_ebwt(built, d):
    """At capacity factor 0.5 the first attempt's buckets overflow; the
    retries double the capacity and the last attempt is exact."""
    got, want = built[d]["retry"], built[d]["example"]
    assert got["overflow"] == 0 and got["attempts"] > 1 and want["attempts"] == 1
    for field in ("bwt", "qs", "lcp", "sa"):
        assert np.array_equal(got[field], want[field]), field

"""The port's sequence-sharded pipeline over 4 gloo ranks against the JAX
package's smooth_fastq_sharded and the port's smooth_fastq, continued from
test_torch_parallel_pipeline.py: mode 3 with Illumina binning and mode 1
(float64 mean-error sums carried across ranks) on example.in.fastq, and
variable-length reads with Ns."""

import numpy as np
import pytest

from tests_util import tiny_batch
from test_torch_parallel_pipeline import CASES as FIRST_CASES
from test_torch_parallel_pipeline import check_case, example, run_world
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)


def variable_lengths():
    return tiny_batch(np.random.default_rng(5), n_reads=50, min_len=18, max_len=24, n_frac=0.02)


CASES = {
    "m3_binning": (example, dict(mode=3, binning=True), 2.5),
    "m1": (example, dict(mode=1), 2.5),
    "variable_lengths": (variable_lengths, dict(k=4, min_cluster=3), 2.5),
}
assert not set(CASES) & set(FIRST_CASES)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_world({k: (make(), cfg, cf) for k, (make, cfg, cf) in CASES.items()},
                     tmp_path_factory)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_pipeline_matches_jax_and_single_device(results, name):
    report = check_case(results, CASES, name)
    assert [a["overflow"] for a in report["attempts"]] == [0]

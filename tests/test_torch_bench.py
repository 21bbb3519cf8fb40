"""bfqzip_tpu_torch.bench: bench.py's workload, its JSON line on the CPU,
and its refusal to run without a card unless --cpu is given."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from bfqzip_tpu import alphabet as jax_alphabet
from bfqzip_tpu_torch import bench
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"metric", "value", "unit", "median", "runs_s", "reads", "read_len", "stages",
        "peak_device_bytes", "seg_scan_launches", "device", "scope"}


def _bench_py_arrays(reads: int, read_len: int, uniform: bool):
    """bench.py:54-66, with the JAX package's alphabet."""
    if uniform:
        rng = np.random.default_rng(0)
        bases = np.array([1, 2, 3, 5], dtype=np.uint8)
        seqs = bases[rng.integers(0, 4, size=(reads, read_len))]
        quals = (33 + rng.integers(2, 42, size=(reads, read_len))).astype(np.uint8)
    else:
        sys.path.insert(0, os.path.join(REPO, "tools"))
        from make_realistic import make

        genome_mb = max(reads * read_len / 34e6, 0.05)
        seq_ascii, quals = make(reads, read_len, genome_mb, 0, 0.005, 0.001)
        seqs = jax_alphabet.encode(seq_ascii)
    return seqs, quals, np.full(reads, read_len, np.int32)


@pytest.mark.parametrize("uniform", [False, True], ids=["realistic", "uniform"])
@pytest.mark.parametrize("reads,read_len", [(3000, 101), (500, 150)])
def test_workload_is_bench_py_s(reads, read_len, uniform):
    batch = bench.workload(reads, read_len, uniform)
    seqs, quals, lengths = _bench_py_arrays(reads, read_len, uniform)
    for got, want in ((batch.seqs, seqs), (batch.quals, quals), (batch.lengths, lengths)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _run(*args, env=None):
    return subprocess.run([sys.executable, "-m", "bfqzip_tpu_torch.bench", *args], cwd=REPO,
                          env={**os.environ, "OMP_NUM_THREADS": "1", **(env or {})},
                          capture_output=True, text=True, timeout=300)


def test_bench_on_the_cpu_prints_one_json_line():
    proc = _run("--cpu", "--reads", "2000", "--reps", "2")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert set(res) == KEYS
    assert (res["metric"], res["unit"], res["reads"], res["read_len"]) == (
        "e2e_smooth_bases_per_sec", "bases/s", 2000, 101)
    assert len(res["runs_s"]) == 2 and res["value"] == pytest.approx(2000 * 101 / min(res["runs_s"]))
    assert 0 < res["median"] <= res["value"]
    assert set(res["stages"]) == {"build_ms", "smooth_ms", "invert_ms"}
    assert all(v > 0 for v in res["stages"].values())
    assert res["device"]["type"] == "cpu" and res["device"]["power_limit"] is None
    assert res["peak_device_bytes"] is None
    assert res["seg_scan_launches"] == [0, 0]  # the CPU takes the plain scans
    assert res["scope"] == "smooth_step on device-resident inputs"


def test_bench_run_in_process_matches_the_batch():
    batch = bench.workload(1000, 80, uniform=True)
    res = bench.run(batch, "cpu", reps=1)
    assert (res["reads"], res["read_len"]) == (1000, 80)
    assert res["value"] == pytest.approx(1000 * 80 / res["runs_s"][0])


def test_bench_without_a_card_names_cuda():
    proc = _run("--reads", "10", env={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "cuda" in proc.stderr and not proc.stdout.strip()


@pytest.mark.parametrize("arg", ["--reads", "--len", "--reps"])
def test_bench_refuses_non_positive_sizes(arg):
    proc = _run("--cpu", arg, "0")
    assert proc.returncode == 2 and "must be positive" in proc.stderr

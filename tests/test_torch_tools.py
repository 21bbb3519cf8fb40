"""The port's microbenchmark and codec tools on the CPU: tools/bench_prims_torch.py,
bench_prims2_torch.py, microbench_sort_torch.py, exp_unstable_sort_torch.py,
exp_overlap_torch.py, bench_cm_torch.py and bench_decode_scaling_torch.py.

Each runs once in a subprocess at a tiny size (its JSON line's keys, its
equality flags, the CPU named); the candidates they time are held here
against independent NumPy answers, and the LPT model against the JAX
tool's."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bfqzip_tpu_torch.ops import scan
from bfqzip_tpu_torch.ops.suffix import _sort_lsd
from bfqzip_tpu_torch.utils import native
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
sys.path.insert(0, TOOLS)

import bench_decode_scaling  # noqa: E402  (the JAX tool: bfqzip_tpu is imported inside measure)
import bench_decode_scaling_torch  # noqa: E402
import bench_prims2_torch  # noqa: E402
import bench_prims_torch  # noqa: E402
import exp_overlap_torch  # noqa: E402
import exp_unstable_sort_torch  # noqa: E402
import microbench_sort_torch  # noqa: E402

N = 256 * 64


def _run(name, *args, env=None):
    proc = subprocess.run([sys.executable, os.path.join(TOOLS, name), *args], cwd=REPO,
                          env={**os.environ, "OMP_NUM_THREADS": "1", **(env or {})},
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout
    return json.loads(lines[0])


def _on_cpu(res):
    assert res["device"]["type"] == "cpu"
    assert res["device"]["power_limit"] is None


# ---- each tool end to end ----

def test_bench_prims_line():
    res = _run("bench_prims_torch.py", "--n", str(N), "--reps", "1", "--cpu")
    _on_cpu(res)
    assert set(res["ms"]) == {
        "cumsum 1D i32 [n]", "cummax 1D i32 [n]", "cumsum [n,27] i32 axis0 + end-gather",
        "cumsum [27,n] i32 last axis + end-gather",
        "blocked sums+MXU prefix + end-gather", "blocked sums only (no in-block prefix)",
        "gather word[cid] (sorted) [n]", "gather rows X[cend] [ncap,27]", "scatter set [n]->[ncap]",
        "scatter-add rows [nb*64,27]->[ncap,27]", "sort 2-op [n]", "sort 4-op [n]", "sort 13-op [n]",
        "expand word[cid] via one-hot MXU"}
    assert all(v > 0 for v in res["ms"].values())
    assert res["checks"] == {"blocked_equal_cumsum": True, "expand_equal_gather": True}


def test_bench_prims2_line():
    res = _run("bench_prims2_torch.py", "--n", str(N), "--reps", "1", "--cpu")
    _on_cpu(res)
    cands = res["candidates"]
    assert set(cands) == set(bench_prims2_torch.CANDIDATES) | {bench_prims2_torch.TWO_LEVEL}
    for row in cands.values():
        assert row["plain_ms"] > 0
        assert row["kernel_ms"] is None and row["equal"] is None  # the kernel needs the card
    assert cands[bench_prims2_torch.TWO_LEVEL]["plain_equal"] is True
    assert res[bench_prims2_torch.SORT]["ms"] > 0
    assert res["seg_scan_launches"] == 0


def test_microbench_sort_line():
    res = _run("microbench_sort_torch.py", "--n", "20000", "--reps", "1", "--cpu")
    _on_cpu(res)
    keys = {f"sort u32 keys={k} +idx stable" for k in (1, 2, 3, 5, 9)}
    keys |= {"sort u32 keys=3 +idx UNstable", "sort u32 keys=9 +idx UNstable",
             "sort u64 keys=3 +idx stable", "sort u64 keys=5 +idx stable", "random gather n x i64",
             "random gather n x i32", "cumsum n", "batched sort [36,555] 9 keys",
             "batched sort [216,92] 9 keys", "scatter n x i32", "sort u32 keys=9 no payload",
             "sort u32 keys=9 +3 payloads"}
    assert set(res["ms"]) == keys
    assert set(res["model"]) == {"per_key_word_ms", "per_payload_ms"}
    # reported, not required: an unstable pass may or may not keep ties in order
    assert set(res["unstable_identical"]) == {"keys=3", "keys=9"}
    assert all(isinstance(v, bool) for v in res["unstable_identical"].values())


def test_exp_unstable_sort_line():
    res = _run("exp_unstable_sort_torch.py", "--reads", "2000", "--reps", "1", "--cpu")
    _on_cpu(res)
    assert res["n_pad"] == 2000 * 102 and res["n_words"] == 5
    for key in ("build_stable_ms", "build_unstable_ms", "invert_stable_ms", "invert_unstable_ms",
                "invert_scatter_ms", "invert_via_sa_ms"):
        assert res[key] > 0
    assert isinstance(res["build_identical"], bool)
    assert res["invert_identical"] is True and res["scatter_identical"] is True


def test_exp_overlap_line():
    res = _run("exp_overlap_torch.py", "--reads", "2000", "--reps", "1", "--cpu")
    _on_cpu(res)
    for name in ("fused_1chunk", "chunked_2_overlap", "chunked_2_serial", "chunked_4_overlap",
                 "chunked_4_serial"):
        assert res[f"{name}_ms"] > 0 and res[f"{name}_mbases_per_s"] > 0
    assert res["chunked_2_enqueue_ms"] > 0 and res["chunked_4_enqueue_ms"] > 0
    assert res["chunks_equal"] is True
    assert res["launches_per_stage_triple"] == [0] and res["seg_scan_launches"] == 0


def test_bench_cm_line():
    if not native.cm_available():
        pytest.skip("native library not built")
    res = _run("bench_cm_torch.py", "--reads", "2000", "--reps", "1")
    _on_cpu(res)
    assert res["host"]["cpu_count"] == os.cpu_count()
    for name in ("dna", "qs"):
        row = res[name]
        assert row["raw"] == 2000 * 102 and 0 < row["compressed"] < row["raw"]
        assert row["enc_mb_s"] > 0 and row["dec_mb_s_1t"] > 0 and row["byte_equal"] is True


def test_bench_decode_scaling_line():
    if not native.cm_available():
        pytest.skip("native library not built")
    res = _run("bench_decode_scaling_torch.py", env={"BENCH_READS": "2000"})
    _on_cpu(res)
    assert [s["stream"] for s in res["streams"]] == ["dna", "qs"]
    cores = len(os.sched_getaffinity(0))
    for s in res["streams"]:
        assert set(s["measured_s"]) == {str(k) for k in (1, 2, 4, 8) if k <= max(cores, 2)}
        assert set(s["modelled_mbps"]) == {"1", "2", "4", "8", "16", "32"}
        assert s["nblocks"] == 1 and s["byte_equal"] is True
        assert s["decodes_checked"] == 3 * len(s["measured_s"])


@pytest.mark.parametrize("tool", [bench_prims_torch, bench_prims2_torch, microbench_sort_torch,
                                  exp_unstable_sort_torch, exp_overlap_torch])
def test_device_tool_needs_a_card_without_cpu(tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tool.main(["--reps", "1"])


# ---- the candidates against NumPy ----

def _flags(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 100, n).astype(np.int32)
    f = rng.random(n) < 0.01
    f[0] = seed % 2 == 1  # a flag at position 0, or none
    return x, f


def _segmented(x, f, fn):
    """fn over each run that a flag starts (the first run continues from 0)."""
    parts = np.split(x, np.flatnonzero(f))
    out = [fn(p, head=(i > 0 or f[0])) for i, p in enumerate(parts) if p.size]
    return np.concatenate(out)


_NUMPY_SCANS = {
    "add": lambda p, head: np.cumsum(p),
    "or": lambda p, head: np.bitwise_or.accumulate(p),
    "keepleft": lambda p, head: np.full_like(p, p[0] if head else 0),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("op", list(_NUMPY_SCANS))
def test_scan_candidates_against_numpy(op, seed):
    x, f = _flags(N, seed)
    got = scan.seg_scan(torch.as_tensor(x), torch.as_tensor(f), op, 0)
    np.testing.assert_array_equal(got.numpy(), _segmented(x, f, _NUMPY_SCANS[op]))


def test_channel_first_sum_against_numpy():
    x, f = _flags(N, 0)
    x5 = np.random.default_rng(3).integers(0, 100, (5, N)).astype(np.int32)
    got = scan.seg_scan(torch.as_tensor(x5), torch.as_tensor(f), "add", 0).numpy()
    for c in range(5):
        np.testing.assert_array_equal(got[c], _segmented(x5[c], f, _NUMPY_SCANS["add"]))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_two_level_against_numpy(seed):
    x, f = _flags(N, seed)
    got = bench_prims2_torch.two_level(torch.as_tensor(x), torch.as_tensor(f), scan.seg_scan)
    np.testing.assert_array_equal(got.numpy(), _segmented(x, f, _NUMPY_SCANS["add"]))


def test_blocked_prefix_against_cumsum():
    t = bench_prims_torch.inputs(N, "cpu")
    x8, cend = t["x8"].numpy(), t["cend64"].numpy()
    want = np.cumsum(x8[:, None] == np.arange(27)[None, :], axis=0)[cend]
    np.testing.assert_array_equal(bench_prims_torch.big_cumsum(t["x8"], t["cend64"]).numpy(), want)
    np.testing.assert_array_equal(bench_prims_torch.big_cumsum_cf(t["x8"], t["cend64"]).numpy(), want)
    np.testing.assert_array_equal(bench_prims_torch.blocked(t["x8"], t["cend64"]).numpy(), want)


def test_expansion_against_gather():
    t = bench_prims_torch.inputs(N, "cpu")
    word, cid = t["word"].numpy(), t["cid"].numpy()
    cb = cid.reshape(-1, 256)
    inside = (cb - cb[:, :1] < 64).reshape(-1)
    assert inside.mean() > 0.5  # most blocks span fewer than 64 cids
    want = np.where(inside, word[cid], 0)
    np.testing.assert_array_equal(bench_prims_torch.expand_mm(t["word"], t["cid"]).numpy(), want)


@pytest.mark.parametrize("k", [1, 2, 3, 5, 9])
def test_sort_lsd_against_lexsort(k):
    rng = np.random.default_rng(k)
    words = [rng.integers(0, 4, 5000, dtype=np.int64) for _ in range(k)]  # many ties
    sa, skeys = _sort_lsd([torch.as_tensor(w) for w in words])
    order = np.lexsort(words[::-1])  # words[0] most significant, ties in position order
    np.testing.assert_array_equal(sa.numpy(), order)
    for got, w in zip(skeys, words):
        np.testing.assert_array_equal(got.numpy(), w[order])


def test_batched_sort_against_rowwise_lexsort():
    rng = np.random.default_rng(4)
    mats = [rng.integers(0, 3, (6, 700), dtype=np.int64) for _ in range(9)]
    idx, skeys = microbench_sort_torch.batched_sort_lsd([torch.as_tensor(m) for m in mats])
    for r in range(6):
        order = np.lexsort([m[r] for m in mats[::-1]])
        np.testing.assert_array_equal(idx[r].numpy(), order)
        for got, m in zip(skeys, mats):
            np.testing.assert_array_equal(got[r].numpy(), m[r][order])


@pytest.mark.parametrize("k", [1, 2, 3, 4, 8, 16, 32])
def test_lpt_makespan_matches_the_jax_tool(k):
    times = list(np.random.default_rng(k).random(41))
    assert bench_decode_scaling_torch.lpt_makespan(times, k) == bench_decode_scaling.lpt_makespan(times, k)


def test_host_info_names_an_unknown_cpu_by_family(monkeypatch, tmp_path):
    from bfqzip_tpu_torch.utils import profiling

    fake = tmp_path / "cpuinfo"
    fake.write_text("processor\t: 0\nvendor_id\t: GenuineIntel\ncpu family\t: 6\nmodel\t\t: 143\n"
                    "model name\t: unknown\n\nprocessor\t: 1\nmodel name\t: another\n")
    real_open = open
    monkeypatch.setattr(profiling, "open", lambda path, *a, **k: real_open(
        fake if path == "/proc/cpuinfo" else path, *a, **k), raising=False)
    info = profiling.host_info()
    assert info["cpu_model"] == "GenuineIntel family 6 model 143"
    assert info["cpu_count"] == os.cpu_count() and info["affinity"] == len(os.sched_getaffinity(0))

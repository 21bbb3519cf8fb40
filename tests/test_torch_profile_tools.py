"""The port's measurement tools on the CPU: tools/profile_build_torch.py,
tools/profile_smooth_torch.py and tools/run_ext10m_torch.py, and the split
of the flat build that the build profiler times."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from bfqzip_tpu_torch import SmoothConfig
from bfqzip_tpu_torch.bench import workload
from bfqzip_tpu_torch.convert import batch_to_tensors
from bfqzip_tpu_torch.engine import smooth_fastq
from bfqzip_tpu_torch.io import ReadBatch, format_fastq, read_fastq
from bfqzip_tpu_torch.ops import suffix
from conftest import golden_path
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")


def _tool(name, *args, env=None):
    proc = subprocess.run([sys.executable, os.path.join(TOOLS, name), *args], cwd=REPO,
                          env={**os.environ, "OMP_NUM_THREADS": "1", **(env or {})},
                          capture_output=True, text=True, timeout=300)
    return proc


def _json(proc):
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


# ---- the split flat build ----

def _batches():
    rng = np.random.default_rng(5)
    n = 300
    lens = rng.integers(-1, 60, n).astype(np.int32)  # inert -1 rows and empty reads too
    seqs = np.where(np.arange(60)[None, :] < lens[:, None],
                    np.array([1, 2, 3, 4, 5], np.uint8)[rng.integers(0, 5, (n, 60))], 0).astype(np.uint8)
    return {
        "example": read_fastq(golden_path("example.in.fastq")),
        "synth_var": read_fastq(golden_path("synth_var.in.fastq")),
        "realistic": workload(2000, 101),
        "ragged": ReadBatch(seqs=seqs, quals=rng.integers(33, 75, (n, 60), dtype=np.uint8), lengths=lens),
    }


BATCHES = _batches()


@pytest.mark.parametrize("name", list(BATCHES))
def test_split_helpers_compose_to_the_flat_build(name):
    seqs, quals, lengths = batch_to_tensors(BATCHES[name], "cpu")
    want = suffix._build_ebwt_flat(seqs, quals, lengths)
    lens, n = suffix._lens_and_n(lengths)
    assert int(n) == int(np.maximum(BATCHES[name].lengths, 0).sum() + (BATCHES[name].lengths >= 0).sum())
    words = suffix._pack(seqs, lens)
    assert len(words) == -(-(seqs.shape[1] + 1) // suffix.PACK6)
    sa, skeys = suffix._sort_lsd(words)
    bwt, qs, pre, text, valid = suffix._post(seqs, quals, lens, sa, n)
    lcp = suffix._lcp(skeys, sa, lens, seqs.shape[1] + 1, valid)
    got = {"bwt": bwt, "qs": qs, "lcp": lcp, "sa": sa.to(torch.int32), "text": text, "n": n, "pre": pre}
    for field, value in got.items():
        assert torch.equal(value, getattr(want, field)), field
    assert torch.equal(valid, torch.arange(sa.shape[0]) < n)
    # the first sorted key is word 0 in suffix order
    assert torch.equal(skeys[0], words[0][sa])


# ---- tools/profile_build_torch.py ----

def test_piece_bytes_formulas():
    sys.path.insert(0, TOOLS)
    from profile_build_torch import piece_bytes

    N, L = 1000, 101
    P, W = N * 102, 5
    assert piece_bytes(N, L) == {
        "pack": N * L + 8 * N + 8 * W * P, "sort": 16 * W * P + 8 * P,
        "post": 2 * N * L + 8 * N + 8 * P + 4 + 5 * P, "lcp": 8 * W * P + 8 * P + 8 * N + P + 4 * P,
        "full": 2 * N * L + 4 * N + 12 * P + 4,
    }
    assert piece_bytes(10, 23)["pack"] == 10 * 23 + 80 + 8 * 1 * 240  # one key word at wp = 24


def test_profile_build_torch_on_the_cpu(tmp_path):
    res = _json(_tool("profile_build_torch.py", "--cpu", "--reads", "3000", "--trace", str(tmp_path)))
    assert (res["reads"], res["read_len"], res["n_pad"], res["n_words"]) == (3000, 101, 306000, 5)
    assert res["device"]["type"] == "cpu" and res["bandwidth_bytes_per_s"] is None
    assert set(res["pieces"]) == {"pack", "sort", "post", "lcp"}
    for p in res["pieces"].values():
        assert p["ms"] > 0 and p["bytes"] > 0 and p["bound_ms"] is None
        assert p["share_of_full"] == pytest.approx(p["ms"] / res["full_build"]["ms"])
    assert res["sum_pieces_ms"] == pytest.approx(sum(p["ms"] for p in res["pieces"].values()))
    assert res["sort_lsd_model"]["passes"] == 5 and res["sort_lsd_model"]["bytes"] == 32 * 5 * 306000
    assert os.path.exists(res["trace"])


def test_profile_build_torch_refuses_the_doubling_width():
    sys.path.insert(0, TOOLS)
    from profile_build_torch import profile

    with pytest.raises(ValueError, match="doubling"):
        profile(workload(20, 400), "cpu")


# ---- tools/profile_smooth_torch.py ----

def test_profile_smooth_torch_on_the_cpu(tmp_path):
    res = _json(_tool("profile_smooth_torch.py", "--cpu", "--reads", "3000", "--trace-dir", str(tmp_path)))
    assert (res["reads"], res["read_len"], res["n_pad"]) == (3000, 101, 306000)
    assert list(res["steps"]) == ["cluster_words", "broadcast_words", "apply_words", "change_counts"]
    for step in [*res["steps"].values(), res["smooth"]]:
        assert step["ms"] > 0
        assert step["seg_scan_launches"] == 0  # the CPU takes the plain scans
        assert step["kernel_launches"] is None and step["kernel_ms"] is None  # no device timeline
    assert res["sum_steps_ms"] == pytest.approx(sum(s["ms"] for s in res["steps"].values()))
    assert res["device"]["type"] == "cpu"


def test_smooth_is_its_profiled_steps():
    """smooth() is cluster_words -> broadcast_words -> apply_words ->
    change_counts, the steps the profiler times."""
    from bfqzip_tpu_torch.ops.scan import LOCAL_OPS as ops
    from bfqzip_tpu_torch.ops.smooth import (apply_words, broadcast_words, change_counts,
                                             cluster_words, smooth)

    cfg = SmoothConfig()
    ebwt = suffix.build_ebwt(*batch_to_tensors(BATCHES["realistic"], "cpu"))
    want = smooth(ebwt, cfg, pre=ebwt.pre)
    word, close, inclu, stats = cluster_words(ebwt.bwt, ebwt.qs, ebwt.lcp, ebwt.n, cfg, ebwt.pre, ops)
    w = broadcast_words(word, close, ops)
    bwt_sub, qs_out, modified, smoothed = apply_words(ebwt.bwt, ebwt.qs, ebwt.pre, w, inclu, cfg)
    stats.update(change_counts(modified, smoothed, ops))
    assert torch.equal(bwt_sub, want.bwt_sub) and torch.equal(qs_out, want.qs)
    assert list(stats) == list(want.stats)
    assert {k: int(v) for k, v in stats.items()} == {k: int(v) for k, v in want.stats.items()}
    assert int(stats["modified"]) > 0


# ---- tools/run_ext10m_torch.py ----

@pytest.fixture(scope="module")
def small_fastq(tmp_path_factory):
    batch = workload(3000, 101)
    path = tmp_path_factory.mktemp("ext") / "small.fastq"
    path.write_bytes(format_fastq(ReadBatch(seqs=batch.seqs, quals=batch.quals, lengths=batch.lengths,
                                            headers=[b"@r%d" % i for i in range(3000)])))
    want, stats = smooth_fastq(batch, SmoothConfig(), device="cpu")
    return path, format_fastq(want, headers=None), stats


@pytest.mark.parametrize("spill", [True, False], ids=["spill", "no_spill"])
def test_run_ext10m_torch_writes_smooth_fastq_s_bytes(tmp_path, small_fastq, spill):
    path, want, want_stats = small_fastq
    out = tmp_path / "out.fq"
    args = ["--cpu", "--mem-gb", "0.002", "--out", str(out)] + ([] if spill else ["--no-spill"])
    res = _json(_tool("run_ext10m_torch.py", str(path), *args, env={"BFQ_SPILL_DIR": str(tmp_path)}))
    assert out.read_bytes() == want
    assert res["stats"] == want_stats and res["bases_changed"] == want_stats["modified"]
    assert (res["spill"], res["reads"], res["total_bases"]) == (spill, 3000, 303000)
    assert res["stage_attribution"]["n_chunks"] > 1 and res["stage_attribution"]["n_segments"] > 1
    assert res["budget_bytes"] == int(0.002 * (1 << 30))
    assert res["device"]["type"] == "cpu" and res["peak_device_bytes"] is None
    assert res["seg_scan_launches"] == 0
    assert res["value"] == pytest.approx(303000 / res["pipeline_s"])
    assert 0 < res["parse_peak_rss_gb"] <= res["peak_host_rss_gb"]


# ---- no tool falls back to the CPU by itself ----

@pytest.mark.parametrize("tool", ["profile_build_torch.py", "profile_smooth_torch.py", "run_ext10m_torch.py"])
def test_tools_without_a_card_name_cuda(tool, small_fastq):
    args = [str(small_fastq[0])] if tool == "run_ext10m_torch.py" else ["--reads", "10"]
    proc = _tool(tool, *args, env={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "cuda" in proc.stderr and not proc.stdout.strip()

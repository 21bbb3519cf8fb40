"""The port's host utilities: checkfastq, profiling, StepLogger's telemetry,
multihost's backend choice, and tools/profile_stages_torch.py, on the CPU."""

import glob
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from bfqzip_tpu.utils import checkfastq as jax_checkfastq
from bfqzip_tpu_torch.config import PipelineConfig, SmoothConfig
from bfqzip_tpu_torch.engine import smooth_fastq
from bfqzip_tpu_torch.io import read_fastq
from bfqzip_tpu_torch.pipeline import run_pipeline
from bfqzip_tpu_torch.utils import check_fastq, checkfastq, profiling
from conftest import GOLDEN_DIR, golden_path
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
INPUTS = sorted(os.path.basename(p) for p in glob.glob(os.path.join(GOLDEN_DIR, "*.in.fastq")))


def _case_path(case: str, tmp_path) -> str:
    if case in INPUTS:
        return golden_path(case)
    if case == "mismatched.fastq":  # |dna| != |qs| in the second record
        path = tmp_path / case
        path.write_bytes(b"@r1\nACGT\n+\nIIII\n@r2\nACGTA\n+\nIIII\n")
        return str(path)
    if case == "wrong_extension.txt":
        path = tmp_path / case
        shutil.copyfile(golden_path("example.in.fastq"), path)
        return str(path)
    assert case == "missing.fastq"
    return str(tmp_path / case)


@pytest.mark.parametrize("case", INPUTS + ["mismatched.fastq", "wrong_extension.txt", "missing.fastq"])
def test_check_fastq_and_main_agree_with_jax(case, tmp_path, capsys):
    path = _case_path(case, tmp_path)
    assert check_fastq(path) == jax_checkfastq.check_fastq(path)
    assert checkfastq.check_extension(path) == jax_checkfastq.check_extension(path)
    rc = checkfastq.main([path])
    out = capsys.readouterr().out
    want_rc = jax_checkfastq.main([path])
    assert (rc, out) == (want_rc, capsys.readouterr().out)
    assert (rc == 0) == (case in INPUTS)


def test_checkfastq_module_cli(tmp_path):
    env = dict(os.environ, PYTHONPATH=REPO)
    for path, rc, msg in ((golden_path("example.in.fastq"), 0, "Valid FASTQ file!"),
                          (str(tmp_path / "missing.fq"), 1, "Invalid FASTQ file!")):
        proc = subprocess.run([sys.executable, "-m", "bfqzip_tpu_torch.utils.checkfastq", path],
                              cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
        assert (proc.returncode, proc.stdout.strip()) == (rc, msg), proc.stderr


# ---- profiling ----

def test_phase_profiler_on_the_cpu(tmp_path):
    prof = profiling.PhaseProfiler(trace_dir=str(tmp_path / "traces"), device="cpu")
    x = torch.arange(100_000)
    with prof.phase("sum"):
        x.sum()
    with prof.phase("sort"):
        x.flip(0).sort()
    assert [r["phase"] for r in prof.records] == ["sum", "sort"]
    assert all(set(r) == {"phase", "seconds"} and r["seconds"] >= 0 for r in prof.records)
    assert prof.report().splitlines()[0].startswith("sum: ")
    with prof.trace("region"):
        x.cumsum(0)
    assert prof.profile is not None and len(prof.profile.key_averages()) > 0
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "region" for e in events)
    tl = profiling.device_timeline(prof.trace_path, "region")
    assert tl["span_ms"] > 0
    assert (tl["busy_ms"], tl["idle_share"], tl["kernels"]) == (None, None, None)


def test_phase_profiler_without_trace_dir_keeps_the_profile():
    prof = profiling.PhaseProfiler(device="cpu")
    with prof.trace():
        torch.ones(10).sum()
    assert prof.profile is not None and prof.trace_path is None


def test_device_timeline_merges_overlaps_and_clips_to_the_span(tmp_path):
    def ev(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    trace = {"traceEvents": [
        ev("user_annotation", "call", 100.0, 1000.0),
        ev("gpu_user_annotation", "call", 100.0, 1000.0),
        ev("kernel", "scan_tiles<int>", 150.0, 100.0),   # 150-250
        ev("kernel", "scan_tiles<int>", 200.0, 100.0),   # overlaps: 150-300 merged
        ev("gpu_memcpy", "Memcpy HtoD", 500.0, 50.0),    # 500-550
        ev("gpu_memset", "Memset", 1050.0, 100.0),       # clipped to 1050-1100
        ev("kernel", "before", 0.0, 50.0),               # outside the span
        ev("cpu_op", "aten::add", 100.0, 900.0),         # host work is not device time
    ]}
    path = tmp_path / "t.json"
    path.write_text(json.dumps(trace))
    tl = profiling.device_timeline(str(path), "call")
    assert tl["span_ms"] == pytest.approx(1.0)
    assert tl["busy_ms"] == pytest.approx(0.25)  # 150 + 50 + 50 us
    assert tl["idle_share"] == pytest.approx(0.75)
    assert tl["kernels"] == {"scan_tiles<int>": {"launches": 2, "ms": pytest.approx(0.2)}}
    with pytest.raises(ValueError, match="0 host spans"):
        profiling.device_timeline(str(path), "other")


def test_device_memory_stats_cpu_is_empty():
    assert profiling.device_memory_stats("cpu") == {}


def test_device_memory_stats_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        profiling.device_memory_stats("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        profiling.PhaseProfiler()


# ---- StepLogger telemetry through the pipeline ----

def test_pipeline_phase_telemetry_on_the_cpu(tmp_path):
    """Every pipeline step records wall time and the host-RSS keys into the
    .log and the report; on the CPU no device-memory keys."""
    shutil.copyfile(golden_path("example.in.fastq"), tmp_path / "r.fastq")
    base = str(tmp_path / "t")
    res = run_pipeline([str(tmp_path / "r.fastq")], PipelineConfig(mode=2), out_base=base, device="cpu")
    phases = res.report["phases"]
    names = [p["phase"] for p in phases]
    for step in ("step1", "step3", "step5"):
        assert any(step in n for n in names), names
    for p in phases:
        assert p["seconds"] >= 0
        assert set(p) == {"phase", "seconds", "host_rss_delta_mb", "host_rss_peak_mb"}, p
    log = open(base + ".log").read()
    assert "host_rss_delta=" in log and "dev_peak=" not in log


# ---- multihost ----

_INIT_WITHOUT_CARD = """
import torch
torch.cuda.is_available = lambda: False
from bfqzip_tpu_torch.parallel import multihost
try:
    multihost.initialize()  # torchrun's env://, never reached
except RuntimeError as e:
    print("raised:", e)
import torch.distributed as dist
print("initialized:", dist.is_initialized())
"""


def test_multihost_initialize_without_a_card_raises():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _INIT_WITHOUT_CARD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "raised: device 'cuda' requested" in proc.stdout
    assert "initialized: False" in proc.stdout


def test_multihost_one_gloo_rank_equals_smooth_fastq(tmp_path):
    import torch.distributed as dist

    from bfqzip_tpu_torch.parallel import multihost

    batch = read_fastq(golden_path("synth_var.in.fastq"))
    want, want_stats = smooth_fastq(batch, SmoothConfig(), device="cpu")
    multihost.initialize(f"file://{tmp_path / 'store'}", world_size=1, rank=0, backend="gloo")
    try:
        comm = multihost.global_comm()
        assert comm.device == torch.device("cpu")
        got, stats = multihost.smooth_fastq_sharded_multihost(batch, SmoothConfig(), comm)
    finally:
        dist.destroy_process_group()
    for field in ("seqs", "quals", "lengths"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    assert stats == want_stats


# ---- tools/profile_stages_torch.py ----

def test_profile_stages_torch_on_the_cpu(tmp_path):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tools", "profile_stages_torch.py"),
                           "--cpu", "--reads", "2000", "--trace-dir", str(tmp_path)],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(res["stages_ms"]) == {"build_ebwt", "smooth", "invert_via_sa"}
    assert all(v > 0 for v in res["stages_ms"].values())
    assert (res["device"], res["reads"], res["bases"]) == ("cpu", 2000, 2000 * 101)
    assert res["idle_share"] is None and res["busy_ms"] is None
    assert res["top_kernels"] is None and res["kernel_ms"] is None
    assert res["seg_scan_launches"] == 0  # the CPU takes the plain scans
    assert os.path.exists(res["trace"])

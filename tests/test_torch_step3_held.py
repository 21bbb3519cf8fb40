"""Step 3 on step 1's arrays: when step 1 runs in the same run_pipeline call,
step1_build hands its bwt, qs, lcp and n to step 3, and they equal what
load_artifacts reads back from the files it wrote (dtype, length, every
element, padding included, and meta); a fresh run ("held") writes the same
.fq, artifacts and meta bytes as a re-run on the same base, which loads the
artifacts from the files ("files"), on the goldens and on a paired input."""

import os
import shutil

import pytest
import torch

from bfqzip_tpu_torch.config import PipelineConfig
from bfqzip_tpu_torch.io.fastq import read_fastq
from bfqzip_tpu_torch.pipeline import _concat, load_artifacts, run_pipeline, step1_build
from bfqzip_tpu_torch.utils.logging import StepLogger

from conftest import golden_path
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

GOLDENS = ["example", "example_r1", "synth_var", "synth_long"]
# mates of different widths: the paired batch pads file 1's reads to file 2's
PAIRED = ("example", "synth_long")


def _inputs(tmp_path, name):
    """The run's input files: one golden, or the two mate files of "paired"."""
    names = PAIRED if name == "paired" else (name,)
    paths = []
    for i, golden in enumerate(names):
        p = str(tmp_path / f"reads_{i + 1}.fastq")
        shutil.copyfile(golden_path(f"{golden}.in.fastq"), p)
        paths.append(p)
    return paths


@pytest.mark.parametrize("name", GOLDENS + ["paired"])
def test_held_arrays_equal_loaded(tmp_path, name):
    batches = [read_fastq(p) for p in _inputs(tmp_path, name)]
    batch = batches[0] if len(batches) == 1 else _concat(batches)
    base = str(tmp_path / "out")
    log = StepLogger(base + ".log", "cpu")
    (held, meta) = step1_build(batch, base, log, "cpu")
    log.close()
    loaded, meta_files = load_artifacts(base, "cpu")
    assert meta == meta_files and meta["n"] == int(batch.lengths.sum()) + batch.num_reads
    assert len(held) == len(loaded) == 4
    for got, want in zip(held, loaded):
        assert got.dtype == want.dtype and got.shape == want.shape and got.device == want.device
        assert torch.equal(got, want)
    assert held[0].shape[0] % 1024 == 0 and held[0].shape[0] >= meta["n"]
    assert held[3].shape == () and int(held[3]) == meta["n"]


@pytest.mark.parametrize("name", ["example", "synth_long", "paired"])
def test_fresh_run_bytes_equal_cached_rerun(tmp_path, name):
    inputs = _inputs(tmp_path, name)
    base = str(tmp_path / "out")
    cfg = PipelineConfig(mode=0)
    outs = [".fq", ".bwt", ".bwt.qs", ".lcp", ".meta.json"]
    if name == "paired":
        outs += ["_1.fq", "_2.fq"]

    fresh = run_pipeline(inputs, cfg, out_base=base, device="cpu")
    assert fresh.report["step3_input"] == "held"
    want = {ext: open(base + ext, "rb").read() for ext in outs}
    for ext in outs:
        if ext.endswith(".fq"):
            os.remove(base + ext)
        else:
            os.utime(base + ext, ns=(0, 0))

    cached = run_pipeline(inputs, cfg, out_base=base, device="cpu")
    assert cached.report["step3_input"] == "files"
    assert "artifacts cached" in open(base + ".log").read()
    assert cached.stats == fresh.stats and fresh.stats["num_clust"] > 0
    for ext in outs:
        if not ext.endswith(".fq"):
            assert os.stat(base + ext).st_mtime_ns == 0, f"{ext} was rewritten"
        assert open(base + ext, "rb").read() == want[ext], ext
    if name == "example":
        with open(golden_path("example.m2b0.fq"), "rb") as f:
            assert want[".fq"] == f.read()


@pytest.mark.parametrize("route", ["rebuild", "blocks", "original"])
def test_step3_input_on_the_other_routes(tmp_path, route):
    """--rebuild over cached artifacts takes the held route again; block mode
    and --original run no step 3 on artifacts and report no step3_input."""
    inputs = _inputs(tmp_path, "example")
    base = str(tmp_path / "out")
    run_pipeline(inputs, PipelineConfig(mode=0), out_base=base, device="cpu")
    if route == "rebuild":
        res = run_pipeline(inputs, PipelineConfig(mode=0, rebuild=True), out_base=base, device="cpu")
        assert res.report["step3_input"] == "held"
    elif route == "blocks":
        res = run_pipeline(inputs, PipelineConfig(mode=0, rebuild=True), out_base=base, blocks=3,
                           device="cpu")
        assert "step3_input" not in res.report
    else:
        res = run_pipeline(inputs, PipelineConfig(mode=1, original=True), out_base=base,
                           device="cpu")
        assert "step3_input" not in res.report

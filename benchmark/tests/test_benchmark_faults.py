"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a run
on the CPU at a small size, with one fault planted in the program (by
monkeypatching its modules): a step that returns its state unchanged (the
smoother hands back the EBWT it was given), half of the batch left out (only
half of the reads are smoothed and returned), and an answer altered where it
is produced (one base of the inversion's output flipped).  A cell without a
fault is correct.  A run in whose processes a module of JAX is found once the
window, the check and the readers are done is refused and prints no result."""

import json
import os
import sys
import types

import pytest
import torch

from conftest import ROOT
import harness
from harness import Refused, run_cell

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    WORKLOADS = json.load(f)["workloads"]
CELLS = [c["name"] for c in WORKLOADS if c["chips"] == 1]
MESH = [c["name"] for c in WORKLOADS if c["chips"] == 4]
SEED = 2**31 + 4242


def _run(cell):
    return run_cell(cell, SEED, 0.2, trace=False, device="cpu", overrides={"count": 1200})


def state_unchanged(monkeypatch):
    from bfqzip_tpu_torch import engine
    from bfqzip_tpu_torch.ops.smooth import SmoothOut

    def smooth(ebwt, cfg, pre=None, ops=None):
        zero = torch.zeros((), dtype=torch.int64)
        stats = {k: zero for k in ("num_clust", "num_clust_discarded", "num_clust_amb_discarded",
                                   "num_clust_mod", "num_clust_alleq", "bases_inside",
                                   "modified", "qs_smoothed")}
        return SmoothOut(bwt_sub=ebwt.bwt, qs=ebwt.qs, stats=stats)

    monkeypatch.setattr(engine, "smooth", smooth)


def half_left_out(monkeypatch):
    from bfqzip_tpu_torch import engine, pipeline
    from bfqzip_tpu_torch.io.fastq import ReadBatch

    real_step = engine.smooth_step

    def smooth_step(seqs, quals, lengths, cfg):
        half = seqs.shape[0] // 2
        inv, stats = real_step(seqs[:half], quals[:half], lengths[:half], cfg)
        return inv._replace(seqs=torch.cat([inv.seqs, seqs[half:]]),
                            quals=torch.cat([inv.quals, quals[half:]]),
                            lengths=torch.cat([inv.lengths, lengths[half:]])), stats

    real_read = pipeline.read_fastq

    def read_fastq(path, *args, **kw):
        b = real_read(path, *args, **kw)
        half = b.num_reads // 2
        return ReadBatch(seqs=b.seqs[:half], quals=b.quals[:half], lengths=b.lengths[:half],
                         headers=b.headers[:half] if b.headers else None)

    monkeypatch.setattr(engine, "smooth_step", smooth_step)
    monkeypatch.setattr(pipeline, "read_fastq", read_fastq)


def answer_altered(monkeypatch):
    from bfqzip_tpu_torch import engine

    def flip(out):
        seqs = out.seqs.clone()
        seqs[0, 0] = 1 + seqs[0, 0] % 5  # another base code
        return out._replace(seqs=seqs)

    real_sa, real_lf = engine.invert_via_sa, engine.invert
    monkeypatch.setattr(engine, "invert_via_sa", lambda *a, **k: flip(real_sa(*a, **k)))
    monkeypatch.setattr(engine, "invert", lambda *a, **k: flip(real_lf(*a, **k)))


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = _run(cell)
    assert r["correct"] and r["failed"] == 0
    assert list(r)[-1] == "checks" and all(v["value"] == 0 for v in r["checks"].values())
    assert isinstance(r["cold_build"], bool)


@pytest.mark.parametrize("cell", CELLS)
def test_jax_loaded_by_the_check_is_refused(monkeypatch, cell):
    """JAX loaded after the window (here by the reference check) is still found."""
    real_load = harness.load_module

    def load_module(kind, name):
        module = real_load(kind, name)
        if kind == "entries":
            real_check = module.check

            def check(state, output):
                monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
                return real_check(state, output)
            module.check = check
        return module

    monkeypatch.delitem(sys.modules, "jax", raising=False)
    monkeypatch.setattr(harness, "load_module", load_module)
    with pytest.raises(Refused, match="jax"):
        _run(cell)


@pytest.mark.parametrize("fault", [state_unchanged, half_left_out, answer_altered])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_caught(monkeypatch, cell, fault):
    fault(monkeypatch)
    r = _run(cell)
    assert not r["correct"]
    assert any(v["value"] > v["limit"] for v in r["checks"].values())

SITE = """import os, sys
sys.path[:0] = [{root!r}, {tests!r}]
import sharded_faults
sharded_faults.plant({fault!r}, rank0=False)
"""


def _run_mesh(cell):
    return run_cell(cell, SEED, 0.2, trace=False, device="cpu", overrides={"count": 400})


@pytest.mark.parametrize("cell", MESH)
def test_mesh_sound_run_is_correct(cell):
    r = _run_mesh(cell)
    assert r["correct"] and r["failed"] == 0


def _plant_in_ranks(monkeypatch, tmp_path, fault):
    """Fault `fault` in rank 0 now and, through sitecustomize, in the others."""
    import sharded_faults

    tests = os.path.dirname(os.path.abspath(__file__))
    (tmp_path / "sitecustomize.py").write_text(SITE.format(root=ROOT, tests=tests, fault=fault))
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (str(tmp_path), os.environ.get("PYTHONPATH", "")) if p))
    return sharded_faults.plant(fault)


@pytest.mark.parametrize("cell", MESH)
def test_mesh_jax_in_another_rank_is_refused(monkeypatch, tmp_path, cell):
    undo = _plant_in_ranks(monkeypatch, tmp_path, "jax_loaded")
    try:
        with pytest.raises(Refused, match="rank 1: jax"):
            _run_mesh(cell)
    finally:
        for obj, attr, orig in reversed(undo):
            setattr(obj, attr, orig)


@pytest.mark.parametrize("fault", ["exchange_left_out", "state_unchanged", "half_left_out", "answer_altered"])
@pytest.mark.parametrize("cell", MESH)
def test_mesh_fault_is_caught(monkeypatch, tmp_path, cell, fault):
    undo = _plant_in_ranks(monkeypatch, tmp_path, fault)
    try:
        r = _run_mesh(cell)
    finally:
        for obj, attr, orig in reversed(undo):
            setattr(obj, attr, orig)
    assert not r["correct"]
    assert any(v["value"] > v["limit"] for v in r["checks"].values())

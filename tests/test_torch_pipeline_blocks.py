"""The port's block mode and paired mode against the JAX pipeline, byte for
byte: equal blocks (the JAX mesh route on the 8 virtual CPU devices, the
port's rank-parallel route on gloo ranks), uneven blocks (the JAX
sequential route, whose dummy reads the port adds too),
paired blocks, paired reorder 1/2 with mates kept aligned, and paired
restore round trips."""

import os
import shutil

import numpy as np
import pytest

from bfqzip_tpu.config import PipelineConfig
from bfqzip_tpu.io.fastq import ReadBatch, format_fastq, read_fastq
from bfqzip_tpu.pipeline import restore_fastq as jax_restore_fastq
from bfqzip_tpu.pipeline import run_pipeline as jax_run_pipeline
from bfqzip_tpu_torch.parallel import mesh
from bfqzip_tpu_torch.pipeline import _block_permutation, restore_fastq, run_pipeline

from conftest import golden_path
from test_torch_pipeline import assert_same_outputs
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def ranks_time_out(monkeypatch):
    """Ranks of the rank-parallel block route that hang fail the test."""
    monkeypatch.setattr(mesh, "JOIN_TIMEOUT_S", 120)


def _both(inputs, cfg, d, **kw):
    jax_run_pipeline(inputs, cfg, out_base=str(d / "jax"), **kw)
    run_pipeline(inputs, cfg, out_base=str(d / "torch"), device="cpu", **kw)
    assert_same_outputs(str(d / "torch"), str(d / "jax"))


def _mates(d, tag_headers=False):
    batch = read_fastq(golden_path("example.in.fastq"))
    paths = []
    for name, lo, hi in (("r1.fastq", 0, 50), ("r2.fastq", 50, 100)):
        hdrs = ([b"@%s_%d" % (name[:2].encode(), i) for i in range(hi - lo)] if tag_headers
                else batch.headers[lo:hi])
        sub = ReadBatch(seqs=batch.seqs[lo:hi], quals=batch.quals[lo:hi],
                        lengths=batch.lengths[lo:hi], headers=hdrs)
        p = d / name
        p.write_bytes(format_fastq(sub))
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("blocks, mode", [(4, 1), (3, 0)])
def test_blocks_byte_equal_to_jax(tmp_path, blocks, mode):
    src = str(tmp_path / "reads.fastq")
    shutil.copyfile(golden_path("example.in.fastq"), src)
    _both([src], PipelineConfig(mode=mode), tmp_path, blocks=blocks)
    jax_route = "mesh-parallel" if blocks == 4 else "block 3/3"
    assert jax_route in open(tmp_path / "jax.log").read()
    # equal blocks take the rank-parallel route where there is a core per rank
    parallel = blocks == 4 and os.cpu_count() >= 4
    torch_route = "rank-parallel" if parallel else f"block {blocks}/{blocks}"
    assert torch_route in open(tmp_path / "torch.log").read()
    fq = open(tmp_path / "torch.fq", "rb").read()
    assert fq.count(b"\n") == 400  # every read survives, dummies dropped


def test_uneven_blocks_pad_with_dummy_reads():
    perm, bounds = _block_permutation(100, 3, None)
    assert np.array_equal(perm, np.arange(100))
    assert bounds == [(0, 34), (34, 68), (68, 100)]  # the last block gets 2 dummies


def test_paired_blocks_byte_equal_to_jax(tmp_path):
    _both(_mates(tmp_path), PipelineConfig(mode=1), tmp_path, blocks=2)
    assert os.path.exists(tmp_path / "torch_1.fq.rans")


@pytest.mark.parametrize("reorder", [1, 2])
def test_paired_reorder_keeps_mates_aligned(tmp_path, reorder):
    _both(_mates(tmp_path, tag_headers=True), PipelineConfig(mode=3), tmp_path, reorder=reorder)
    h1 = open(tmp_path / "torch_1.fq", "rb").read().split(b"\n")[0::4][:-1]
    h2 = open(tmp_path / "torch_2.fq", "rb").read().split(b"\n")[0::4][:-1]
    assert len(h1) == len(h2) == 50
    if reorder == 1:
        assert h1 != [b"@r1_%d" % i for i in range(50)], "reorder was a no-op"
    for a, b in zip(h1, h2):
        assert a.split(b"_")[1] == b.split(b"_")[1], (a, b)


@pytest.mark.parametrize("mode", [1, 2, 3])
def test_paired_restore_round_trip(tmp_path, mode):
    cfg = PipelineConfig(mode=mode, headers=mode == 3)
    _both(_mates(tmp_path), cfg, tmp_path)
    base = str(tmp_path / "torch")
    got = restore_fastq(base, str(tmp_path / "restored.fastq"))
    want = jax_restore_fastq(base, str(tmp_path / "restored_jax.fastq"))
    assert isinstance(got, tuple) and len(got) == 2
    for g, w, fq in zip(got, want, (base + "_1.fq", base + "_2.fq")):
        body = open(g, "rb").read()
        assert body == open(w, "rb").read()
        lines, want_lines = body.split(b"\n"), open(fq, "rb").read().split(b"\n")
        assert lines[1::4] == want_lines[1::4] and lines[3::4] == want_lines[3::4]
        if mode != 2:
            assert body == open(fq, "rb").read()

"""The pipeline's one output stage: step 4's streams and the paired _1/_2
halves are cut from the bytes the writer formatted, equal to the line-list
expressions they replace (lines[1::4], lines[3::4], the 4*n1 cut with its
rstrip, and the restore side's newline scan); a fresh run never reads its
.fq back, and --original reads its copy once; and the batch is hashed at
most once a run_pipeline call, with meta.json the bytes a run on a fresh
base writes."""

import builtins
import os
import shutil

import numpy as np
import pytest

from bfqzip_tpu_torch import pipeline
from bfqzip_tpu_torch.config import PipelineConfig
from bfqzip_tpu_torch.pipeline import _finish_pipeline, _split_pair, run_pipeline
from bfqzip_tpu_torch.utils.logging import StepLogger

from conftest import golden_path
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

# (body, n1): merged FASTQ bodies, file-1 records then file-2 records
BODIES = {
    "well_formed": (b"@a\nACGT\n+\nIIII\n@b\nGG\n+\nII\n@c\nT\n+\nI\n", 2),
    "no_final_newline": (b"@a\nACGT\n+\nIIII\n@b\nGG\n+\nII", 1),
    "plus_name": (b"@a\nACGT\n+a\nIIII\n@b\nGG\n+b\nII\n", 1),
    "empty_second_mate": (b"@a\nACGT\n+\nIIII\n@b\nGG\n+\nII\n", 2),
    "empty_first_mate": (b"@a\nACGT\n+\nIIII\n", 0),
}


def _newline_scan(data: bytes, n1: int):
    """The restore side's mate cut before the line bounds: 4*n1 finds."""
    cut = 0
    for _ in range(4 * n1):
        nl = data.find(b"\n", cut)
        if nl < 0:
            raise ValueError(f"merged archive has fewer than {n1} file-1 records")
        cut = nl + 1
    return data[:cut], data[cut:]


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("case", list(BODIES))
def test_cuts_equal_the_line_list_expressions(tmp_path, case):
    body, n1 = BODIES[case]
    lines = body.split(b"\n")
    src = tmp_path / "in.fastq"
    src.write_bytes(body)
    base = str(tmp_path / "o")
    log = StepLogger(base + ".log", "cpu")
    _finish_pipeline([str(src)], PipelineConfig(mode=2, codecs=()), base, log, {}, n1,
                     np.frombuffer(body, np.uint8))
    assert _read(base + ".fq.dna") == b"\n".join(lines[1::4]) + b"\n"
    assert _read(base + ".fq.qs") == b"\n".join(lines[3::4]) + b"\n"
    cut = 4 * n1
    assert _read(base + "_1.fq") == b"\n".join(lines[:cut]) + b"\n"
    assert _read(base + "_2.fq") == b"\n".join(lines[cut:]).rstrip(b"\n") + b"\n"
    assert _split_pair(body, n1) == _newline_scan(body, n1)
    if case == "empty_second_mate":  # each side keeps its own bytes
        assert _read(base + "_2.fq") == b"\n" and _split_pair(body, n1)[1] == b""
    with pytest.raises(ValueError, match="fewer than"):
        _split_pair(body, len(lines))


def _mates(d):
    """example.in.fastq's first 50 records as file 1, the next 50 as file 2."""
    lines = _read(golden_path("example.in.fastq")).split(b"\n")
    paths = []
    for name, lo, hi in (("r1.fastq", 0, 200), ("r2.fastq", 200, 400)):
        (d / name).write_bytes(b"\n".join(lines[lo:hi]) + b"\n")
        paths.append(str(d / name))
    return paths


RUNS = {
    "mode2": (PipelineConfig(mode=2), False, {}),
    "mode3": (PipelineConfig(mode=3), False, {}),
    "paired_mode1": (PipelineConfig(mode=1), True, {}),
    "blocks_mode2": (PipelineConfig(mode=2), False, {"blocks": 3}),
    "paired_blocks_mode3": (PipelineConfig(mode=3), True, {"blocks": 3}),
}


@pytest.mark.parametrize("tag", list(RUNS))
def test_fresh_run_never_reads_its_fq_back(tmp_path, monkeypatch, tag):
    cfg, paired, kw = RUNS[tag]
    if paired:
        inputs = _mates(tmp_path)
    else:
        inputs = [str(tmp_path / "reads.fastq")]
        shutil.copyfile(golden_path("example.in.fastq"), inputs[0])
    base = str(tmp_path / "out")
    fq = os.path.abspath(base + ".fq")

    def guarded_open(path, mode="r", *args, **kwargs):
        if os.path.abspath(str(path)) == fq and not any(c in mode for c in "wa"):
            raise AssertionError(f"{path} read back")
        return builtins.open(path, mode, *args, **kwargs)

    real_read = pipeline.read_fastq

    def guarded_read(path, *args, **kwargs):
        assert os.path.abspath(path) != fq, f"{path} parsed back"
        return real_read(path, *args, **kwargs)

    monkeypatch.setattr(pipeline, "open", guarded_open, raising=False)
    monkeypatch.setattr(pipeline, "read_fastq", guarded_read)
    result = run_pipeline(inputs, cfg, out_base=base, device="cpu", **kw)
    monkeypatch.undo()

    lines = _read(base + ".fq").split(b"\n")
    assert len(lines) == 401
    if cfg.mode in (2, 3):
        assert _read(base + ".fq.dna") == b"\n".join(lines[1::4]) + b"\n"
        assert _read(base + ".fq.qs") == b"\n".join(lines[3::4]) + b"\n"
    if paired:
        assert _read(base + "_1.fq") == b"\n".join(lines[:200]) + b"\n"
        assert _read(base + "_2.fq") == b"\n".join(lines[200:]).rstrip(b"\n") + b"\n"
    assert result.outputs["rans"]


@pytest.mark.parametrize("mode", [2, 3])
def test_original_cuts_its_copy(tmp_path, mode):
    """--original has no formatted bytes: step 4 reads the copied .fq once."""
    src = tmp_path / "reads.fastq"
    shutil.copyfile(golden_path("example.in.fastq"), src)
    base = str(tmp_path / "out")
    run_pipeline([str(src)], PipelineConfig(mode=mode, original=True), out_base=base, device="cpu")
    lines = src.read_bytes().split(b"\n")
    assert _read(base + ".fq") == src.read_bytes()
    assert _read(base + ".fq.dna") == b"\n".join(lines[1::4]) + b"\n"
    assert _read(base + ".fq.qs") == b"\n".join(lines[3::4]) + b"\n"
    assert os.path.exists(base + ".h") == (mode == 3)


def _fresh(tmp_path, name):
    src = str(tmp_path / "reads.fastq")
    shutil.copyfile(golden_path("example.in.fastq"), src)
    return [src], str(tmp_path / name)


def _run(inputs, base, **kw):
    cfg = PipelineConfig(mode=0, rebuild=kw.pop("rebuild", False))
    return run_pipeline(inputs, cfg, out_base=base, device="cpu", **kw)


# state of the output base -> (run keywords, hashes of the batch)
HASHES = {
    "fresh": ({}, 1),  # step 1's meta.json
    "cached": ({}, 1),  # the cache check, which hits
    "rebuild": ({"rebuild": True}, 1),  # step 1's meta.json, no check
    "changed": ({}, 1),  # the cache check, whose digest step 1 records
    "fresh_blocks": ({"blocks": 3}, 0),  # block mode writes no artifacts
}


@pytest.mark.parametrize("state", list(HASHES))
def test_batch_hashed_at_most_once(tmp_path, monkeypatch, state):
    kw, hashes = HASHES[state]
    inputs, base = _fresh(tmp_path, "out")
    if state in ("cached", "rebuild", "changed"):
        _run(inputs, base)
    if state == "changed":
        shutil.copyfile(golden_path("synth_var.in.fastq"), inputs[0])
    calls = []
    real = pipeline._fingerprint
    monkeypatch.setattr(pipeline, "_fingerprint", lambda b: calls.append(1) or real(b))
    _run(inputs, base, **kw)
    assert len(calls) == hashes
    if "blocks" not in kw:  # meta.json is the bytes of a run on a fresh base
        monkeypatch.undo()
        _run(inputs, str(tmp_path / "fresh_base"))
        assert _read(base + ".meta.json") == _read(str(tmp_path / "fresh_base.meta.json"))
    assert ("artifacts cached" in _read(base + ".log").decode()) == (state == "cached")

"""The port's CLI: compress, restore and decompress run end to end in a
process where jax cannot be imported; --ext-mem writes the JAX CLI's files;
the parser's exit codes; --mesh 4 over gloo ranks, byte-equal to the JAX
CLI's mesh, and refused on CUDA above the card count; and no silent CPU run
when CUDA is asked for without a card."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from bfqzip_tpu import cli as jax_cli
from bfqzip_tpu_torch.utils import native
from bfqzip_tpu_torch import cli
from bfqzip_tpu_torch.parallel import mesh

from conftest import golden_path
from test_torch_pipeline import assert_same_outputs
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RUN_BLOCKED = """
import runpy, sys

class BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError(f"jax is blocked: {name}")
        return None

sys.meta_path.insert(0, BlockJax())
inp, base = sys.argv[1], sys.argv[2]
runs = [
    [inp, "-o", base, "--m3", "--cpu"],
    ["--restore", base, "-o", base + ".restored.fastq", "--cpu"],
    ["--decompress", base + ".fq.dna.rans", base + ".fq.qs.rans", base + ".h.rans", "--cpu"],
]
for argv in runs:
    sys.argv = ["bfqzip_tpu_torch", *argv]
    try:
        runpy.run_module("bfqzip_tpu_torch", run_name="__main__", alter_sys=True)
    except SystemExit as e:
        if e.code != 0:
            raise
assert not any(m.split(".")[0] in ("jax", "jaxlib") for m in sys.modules)
print("ran", len(runs))
"""


def test_cli_runs_with_jax_blocked(tmp_path):
    src = str(tmp_path / "reads.fastq")
    shutil.copyfile(golden_path("example.in.fastq"), src)
    base = str(tmp_path / "out")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _RUN_BLOCKED, src, base], cwd=str(tmp_path),
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ran 3" in proc.stdout
    fq = open(base + ".fq", "rb").read()
    with open(golden_path("example.m2b0h.fq"), "rb") as f:
        assert fq == f.read()
    assert open(base + ".restored.fastq", "rb").read() == fq
    # --decompress wrote each stream back over its original name
    lines = fq.split(b"\n")
    assert open(base + ".fq.dna", "rb").read() == b"\n".join(lines[1::4]) + b"\n"
    assert open(base + ".fq.qs", "rb").read() == b"\n".join(lines[3::4]) + b"\n"
    assert open(base + ".h", "rb").read() == b"\n".join(lines[0:-1:4]) + b"\n"
    assert "restored" in proc.stdout and "MB/s" in proc.stdout


def test_decompress_to_named_output(tmp_path):
    src = str(tmp_path / "reads.fastq")
    shutil.copyfile(golden_path("example.in.fastq"), src)
    base = str(tmp_path / "o")
    assert cli.main([src, "-o", base, "-2", "--cpu"]) == 0
    assert cli.main(["--decompress", base + ".fq.qs.rans", "-o", base + ".qs.out", "--cpu"]) == 0
    assert open(base + ".qs.out", "rb").read() == open(base + ".fq.qs", "rb").read()
    assert cli.main(["--decompress", base + ".fq.qs.rans", base + ".fq.dna.rans", "-o", "x"]) == 2


def test_bad_arguments_exit_2(tmp_path, capsys):
    assert cli.main(["a.fastq", "b.fastq", "--cpu"]) == 2
    assert "paired" in capsys.readouterr().err
    assert cli.main([str(tmp_path / "missing.fastq"), "--cpu"]) == 2
    assert "not found" in capsys.readouterr().err
    assert cli.main(["--restore", "a", "b"]) == 2
    with pytest.raises(SystemExit) as e:
        cli.main(["x.fastq", "--no-such-flag"])
    assert e.value.code == 2
    assert "bfqzip_tpu_torch" in capsys.readouterr().err


def test_mesh_flag_byte_equal_to_jax(tmp_path, monkeypatch):
    """--mesh 4 --cpu runs ONE global EBWT over 4 gloo ranks and writes the
    JAX CLI's files (--mesh 4 on its 4-device mesh)."""
    monkeypatch.setattr(mesh, "JOIN_TIMEOUT_S", 120)  # a hang fails the test
    src = str(tmp_path / "reads.fastq")
    shutil.copyfile(golden_path("example.in.fastq"), src)
    assert jax_cli.main([src, "-o", str(tmp_path / "jax"), "--m3", "--mesh", "4"]) == 0
    assert cli.main([src, "-o", str(tmp_path / "torch"), "--m3", "--mesh", "4", "--cpu"]) == 0
    assert_same_outputs(str(tmp_path / "torch"), str(tmp_path / "jax"))
    assert "sequence-sharded over 4 ranks" in open(tmp_path / "torch.log").read()


def test_mesh_above_card_count_exits_nonzero(tmp_path, capsys, monkeypatch):
    """--mesh 2 on CUDA with one card refuses, naming both counts, before
    any file is written: two ranks never share a card silently."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    src = golden_path("example.in.fastq")
    assert cli.main([src, "-o", str(tmp_path / "o"), "--m3", "--mesh", "2"]) != 0
    err = capsys.readouterr().err
    assert "2 ranks need 2 CUDA devices" in err and "device_count() is 1" in err
    assert os.listdir(tmp_path) == []


def test_cuda_without_card_exits_nonzero(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src = golden_path("example.in.fastq")
    rc = cli.main([src, "-o", str(tmp_path / "o"), "--m3"])
    assert rc != 0
    assert "cuda" in capsys.readouterr().err
    assert os.listdir(tmp_path) == []


@pytest.mark.skipif(not native.ext_merge_available(), reason="native library not built")
@pytest.mark.parametrize("flags", [["--m3"], ["-1", "--mem", "1"]])
def test_ext_mem_writes_the_jax_cli_files(tmp_path, monkeypatch, flags):
    """--ext-mem through both CLIs: every output file but the log is the
    same bytes (a 1 MB budget splits the port's run into chunks and
    segments)."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jax_cache"))
    src = str(tmp_path / "reads.fastq")
    shutil.copyfile(golden_path("example.in.fastq"), src)
    for pkg, main in (("jax", jax_cli.main), ("torch", cli.main)):
        os.mkdir(tmp_path / pkg)
        assert main([src, "-o", str(tmp_path / pkg / "out"), "--ext-mem", "--cpu", *flags]) == 0
    assert_same_outputs(str(tmp_path / "torch" / "out"), str(tmp_path / "jax" / "out"))
    assert "external memory" in open(tmp_path / "torch" / "out.log").read()

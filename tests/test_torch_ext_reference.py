"""The CLI's out-of-core route against the benchmark's plain reference: with
--ext-mem at a budget that splits the file into several chunk sorts and two
smoothing segments, the .fq is byte-equal to benchmark/reference/ebwt.py's,
on the benchmark's read model, with and without -B.  Nothing here imports
JAX or the JAX package."""

import ast
import json
import os
import sys

import pytest
import torch

from bfqzip_tpu_torch import cli
from bfqzip_tpu_torch.utils import native
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from gen import reads as gen  # noqa: E402
from reference import ebwt as ref  # noqa: E402

with open(os.path.join(BENCH, "configs", "hiseq101ext.json")) as f:
    CONFIG = json.load(f)
# 700 x 101 bp: 71,400 positions, two segments (the segment floor is 65,536
# positions) and seven chunk sorts under a 2 MB budget
READS = dict(CONFIG["reads"], count=700)


@pytest.mark.skipif(not native.ext_merge_available(), reason="no C++ compiler for the merge")
@pytest.mark.parametrize("binning", [False, True], ids=["B0", "B1"])
@pytest.mark.parametrize("seed", [2**31 + 11, 2**31 + 12, 2**33 + 13])
def test_ext_mem_fq_equals_the_reference(tmp_path, monkeypatch, capsys, seed, binning):
    monkeypatch.setenv("BFQ_SPILL_DIR", str(tmp_path))
    seqs, quals, lengths = gen.make(READS, seed, "cpu")
    src = str(tmp_path / "in.fastq")
    with open(src, "wb") as f:
        f.write(gen.fastq_bytes(seqs.numpy(), quals.numpy()))
    base = str(tmp_path / "out")
    args = [src, "-o", base, "-0", "--ext-mem", "--mem", "2", "-v", "1", "--cpu"]
    assert cli.main(args + ["-B"] * binning) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("external: ")]
    report = ast.literal_eval(line[0][len("external: "):])
    assert report["n_chunks"] >= 2 and report["n_segments"] >= 2 and report["spill"]

    want = ref.smooth_reads(seqs, quals, lengths, dict(CONFIG["smooth"], binning=binning))
    expected = ref.fastq_bytes(want["seqs"], want["quals"], lengths)
    got = open(base + ".fq", "rb").read()
    assert len(got) == len(expected)
    assert got == expected
    if binning:  # -B changes the qualities the reference leaves whole
        plain = ref.smooth_reads(seqs, quals, lengths, dict(CONFIG["smooth"]))
        assert not torch.equal(plain["quals"], want["quals"])

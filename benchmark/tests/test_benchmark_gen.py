"""The read generator: deterministic by seed, the configured shape and alphabet."""

import json
import os

import numpy as np
import pytest
import torch

from conftest import BENCH
from gen import reads as gen

READS = {"count": 400, "length": 101, "coverage": 20, "error_rate": 0.005, "n_rate": 0.01,
         "quality": {"plateau": 38, "drop": 8, "sd": 3, "min": 2, "max": 40}}


def test_same_seed_same_reads():
    a = gen.make(READS, 2**31 + 12345, "cpu")
    b = gen.make(READS, 2**31 + 12345, "cpu")
    c = gen.make(READS, 2**31 + 12346, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


def test_shape_and_alphabet():
    seqs, quals, lengths = gen.make(READS, 7, "cpu")
    assert seqs.shape == quals.shape == (400, 101) and seqs.dtype == quals.dtype == torch.uint8
    assert set(torch.unique(seqs).tolist()) <= {1, 2, 3, 4, 5}
    assert int(quals.min()) >= 33 + 2 and int(quals.max()) <= 33 + 40
    assert bool((quals[seqs == 4] == 35).all())  # N calls carry quality 2
    assert torch.equal(lengths, torch.full((400,), 101, dtype=torch.int32))
    # reads overlap at 20x coverage: many 16-mers recur
    kmers = {bytes(r[i:i + 16]) for r in seqs.numpy() for i in range(0, 80, 20)}
    assert len(kmers) < 400 * 4


def test_fastq_writer_round_trip():
    seqs, quals, _ = (t.numpy() for t in gen.make(READS, 3, "cpu"))
    data = gen.fastq_bytes(seqs, quals)
    lines = data.split(b"\n")
    assert lines[-1] == b"" and len(lines) == 4 * 400 + 1
    assert lines[0] == b"@BENCH.000000001 000000001 length=101"
    table = np.frombuffer(b"#ACGNT", dtype=np.uint8)
    assert lines[1] == table[seqs[0]].tobytes() and lines[2] == b"+" and lines[3] == quals[0].tobytes()
    assert lines[4 * 399] == b"@BENCH.000000400 000000400 length=101"


@pytest.mark.parametrize("name", sorted(f[:-5] for f in os.listdir(os.path.join(BENCH, "configs"))))
def test_config_reads_section(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        reads = json.load(f)["reads"]
    small = dict(reads, count=50)
    seqs, quals, lengths = gen.make(small, 1, "cpu")
    assert seqs.shape == (50, reads["length"])
    assert gen.genome_length(reads) > reads["length"]

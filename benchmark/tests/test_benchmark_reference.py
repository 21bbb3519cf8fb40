"""The plain reference against the golden outputs of the reference tool.

The goldens (tests/golden/, made by compiling BFQzip's own bfq_int) are read
as data files: the input FASTQ, and the smoothed FASTQ of each mode and
binning without headers, compared byte for byte."""

import json
import os

import numpy as np
import pytest
import torch

from conftest import ROOT
from reference import ebwt as ref

GOLDEN = os.path.join(ROOT, "tests", "golden")
CODES = np.full(256, 255, dtype=np.uint8)
for byte, code in zip(b"ACGNT", (ref.A, ref.C, ref.G, ref.N, ref.T)):
    CODES[byte] = code


def _cases():
    with open(os.path.join(GOLDEN, "manifest.json")) as f:
        manifest = json.load(f)
    return sorted((k, v) for k, v in manifest.items() if not v["headers"])


def parse(path):
    lines = open(path, "rb").read().split(b"\n")
    n = len(lines) // 4
    seqs, quals = lines[1:4 * n:4], lines[3:4 * n:4]
    width = max(len(s) for s in seqs)
    S = np.zeros((n, width), np.uint8)
    Q = np.zeros((n, width), np.uint8)
    L = np.zeros(n, np.int32)
    for i, (s, q) in enumerate(zip(seqs, quals)):
        S[i, :len(s)] = CODES[np.frombuffer(s, np.uint8)]
        Q[i, :len(q)] = np.frombuffer(q, np.uint8)
        L[i] = len(s)
    return S, Q, L


@pytest.mark.parametrize("name,case", _cases(), ids=[k for k, _ in _cases()])
def test_golden(name, case):
    S, Q, L = parse(os.path.join(GOLDEN, case["dataset"] + ".in.fastq"))
    cfg = {"k": 16, "min_cluster": 5, "mode": case["mode"], "default_qs": ord(">"),
           "quality_threshold": 20, "freq_threshold": 40.0, "binning": bool(case["binning"]),
           "border": 1}
    out = ref.smooth_reads(torch.from_numpy(S), torch.from_numpy(Q), torch.from_numpy(L), cfg)
    got = ref.fastq_bytes(out["seqs"], out["quals"], L)
    with open(os.path.join(GOLDEN, name + ".fq"), "rb") as f:
        assert got == f.read()


def test_suffix_order_and_lcp_brute_force():
    """SA and LCP of a small random batch against sorting the suffixes as tuples."""
    g = torch.Generator().manual_seed(5)
    n_reads, width = 30, 12
    seqs = torch.randint(1, 6, (n_reads, width), generator=g, dtype=torch.uint8)
    lengths = torch.randint(1, width + 1, (n_reads,), generator=g, dtype=torch.int32)
    seqs[torch.arange(width)[None, :] >= lengths[:, None].long()] = 0
    t = ref.text_of(seqs, seqs, lengths)
    text = t["text"].tolist()
    n = len(text)
    want = sorted(range(n), key=lambda p: text[p:] + text[:p])
    sa, levels = ref.suffix_array(t["text"], n_reads)
    assert sa.tolist() == want
    lcp = ref.lcp_of(sa, levels).tolist()
    for j in range(1, n):
        a, b = text[want[j - 1]:], text[want[j]:]
        k = 0
        while k < min(len(a), len(b)) and a[k] == b[k]:
            k += 1
        assert lcp[j] == k


def test_blocks_do_not_change_the_result(monkeypatch):
    """The passes that run in blocks of positions give the same output with
    many small blocks as with one."""
    from gen import reads as gen

    reads = {"count": 300, "length": 101, "coverage": 20, "error_rate": 0.01, "n_rate": 0.01,
             "quality": {"plateau": 38, "drop": 8, "sd": 3, "min": 2, "max": 40}}
    seqs, quals, lengths = gen.make(reads, 11, "cpu")
    cfg = {"k": 16, "min_cluster": 5, "mode": 2, "default_qs": 62, "quality_threshold": 20,
           "freq_threshold": 40.0, "binning": False, "border": 1}
    whole = ref.smooth_reads(seqs, quals, lengths, cfg, artifacts=True)
    monkeypatch.setattr(ref, "BLOCK", 997)
    blocked = ref.smooth_reads(seqs, quals, lengths, cfg, artifacts=True)
    assert whole["stats"] == blocked["stats"] and whole["stats"]["num_clust"] > 100
    for k in ("seqs", "quals", "bwt", "qs", "lcp"):
        assert torch.equal(whole[k], blocked[k]), k

"""Reads made from a seed, on the device: Illumina-like reads of a synthetic genome.

The read model of the repository's `tools/make_realistic.py` (reads sampled
from a random genome at a stated coverage, so positional clusters exist;
both strands; a quality profile with a high plateau, a 3' decline and
Gaussian noise, clipped; substitution errors biased to low qualities; rare N
calls at quality 2), rewritten in PyTorch so that a batch of millions of
reads is made on the card in a few large calls.  The same seed on the same
device gives the same reads; a CUDA generator and a CPU one give different
reads.
"""

from __future__ import annotations

import numpy as np
import torch

from reference.ebwt import A, C, G, N, T

_CODE_OF_BASE = (A, C, G, T)  # genome symbols 0..3 -> base codes


def genome_length(reads: dict) -> int:
    """Genome size that gives the configured coverage."""
    return int(round(reads["count"] * reads["length"] / reads["coverage"]))


def make(reads: dict, seed: int, device) -> tuple:
    """(seqs [N, L] uint8 base codes, quals [N, L] uint8 raw ASCII, lengths
    [N] int32) on `device`, for a configuration's `reads` section."""
    n, length = reads["count"], reads["length"]
    qm = reads["quality"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    glen = genome_length(reads)
    genome = torch.randint(0, 4, (glen,), generator=gen, device=device, dtype=torch.uint8)
    start = torch.randint(0, glen - length, (n,), generator=gen, device=device)
    offs = torch.arange(length, device=device)
    sym = genome[start[:, None] + offs[None, :]]
    del genome, start
    reverse = torch.rand(n, generator=gen, device=device) < 0.5
    sym = torch.where(reverse[:, None], 3 - sym.flip(1), sym)
    del reverse

    # Phred: plateau - drop * (pos / L)^2 + N(0, sd), clipped, truncated
    mean = qm["plateau"] - qm["drop"] * (offs.to(torch.float32) / length) ** 2
    phred = torch.randn((n, length), generator=gen, device=device) * qm["sd"] + mean
    phred = phred.clamp_(qm["min"], qm["max"]).to(torch.uint8)

    p_err = reads["error_rate"] * torch.pow(10.0, (20.0 - phred.to(torch.float32)) / 30.0)
    is_err = torch.rand((n, length), generator=gen, device=device) < p_err
    del p_err
    shift = torch.randint(1, 4, (n, length), generator=gen, device=device, dtype=torch.uint8)
    sym = torch.where(is_err, (sym + shift) % 4, sym)
    del is_err, shift
    is_n = torch.rand((n, length), generator=gen, device=device) < reads["n_rate"]
    phred = torch.where(is_n, 2, phred)

    codes = torch.tensor(_CODE_OF_BASE, dtype=torch.uint8, device=device)
    seqs = torch.where(is_n, N, codes[sym.to(torch.int64)])
    quals = phred + 33
    lengths = torch.full((n,), length, dtype=torch.int32, device=device)
    return seqs, quals, lengths


_BASES = np.frombuffer(b"#ACGNT", dtype=np.uint8)


def fastq_bytes(seqs: np.ndarray, quals: np.ndarray, tag: str = "BENCH") -> bytes:
    """Equal-length reads as FASTQ with Illumina-like numbered headers
    ('@<tag>.<i> <i> length=<L>', i zero-padded to 9 digits), built in one
    array."""
    n, length = seqs.shape
    head = f"@{tag}.".encode()
    tail = f" length={length}\n".encode()
    digits = 9
    layout = [head, digits, b" ", digits, tail, length, b"\n+\n", length, b"\n"]
    width = sum(len(p) if isinstance(p, bytes) else p for p in layout)
    rec = np.empty((n, width), dtype=np.uint8)
    number = np.arange(1, n + 1, dtype=np.int64)
    places = 10 ** np.arange(digits - 1, -1, -1, dtype=np.int64)
    num = (number[:, None] // places[None, :] % 10 + ord("0")).astype(np.uint8)
    at = 0
    fields = iter((num, num, _BASES[seqs], quals))
    for part in layout:
        if isinstance(part, bytes):
            rec[:, at:at + len(part)] = np.frombuffer(part, dtype=np.uint8)
            at += len(part)
        else:
            rec[:, at:at + part] = next(fields)
            at += part
    return rec.tobytes()

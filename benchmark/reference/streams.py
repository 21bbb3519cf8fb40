"""The streams of BFQzip's mode 3 (`--m3`) in plain NumPy: what a file's
smoothed reads and header lines become before entropy coding.

    .fq       the smoothed FASTQ, each record's header line as the input gave it
    .fq.dna   step 4's DNA stream: each record's bases, then a newline
    .fq.qs    step 4's quality stream: each record's qualities, then a newline
    .h        the header lines, each followed by a newline

(BFQzip.py: step 4 cuts lines 2 and 4 of every record of the .fq; step 2
writes the headers.)  Reads are base codes of reference/ebwt.py with raw
ASCII qualities; nothing here imports the program.  The archive's
containers are not rebuilt here: a lossless archive is checked by restoring
it and comparing with the .fq.
"""

from __future__ import annotations

import numpy as np
import torch

from reference.ebwt import DECODE


def _numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _header_rows(headers) -> tuple:
    """The header lines as ([n, width] uint8 rows, [n] lengths)."""
    lens = np.fromiter((len(h) for h in headers), dtype=np.int64, count=len(headers))
    width = int(lens.max()) if len(headers) else 0
    flat = np.frombuffer(b"".join(headers), dtype=np.uint8)
    start = np.concatenate(([0], np.cumsum(lens)[:-1])).astype(np.int64)
    col = np.arange(width)
    inside = col[None, :] < lens[:, None]
    rows = np.zeros((len(headers), width), dtype=np.uint8)
    rows[inside] = flat[(start[:, None] + col[None, :])[inside]]
    return rows, lens


def _records(parts, n: int) -> bytes:
    """Records of `parts` one after another: each part is literal bytes, the
    same in every record, or a pair of ([n, width] uint8 rows, [n] lengths),
    each row cut to its length."""
    sizes = [np.full(n, len(p), dtype=np.int64) if isinstance(p, bytes) else p[1].astype(np.int64)
             for p in parts]
    at = np.concatenate(([0], np.cumsum(sum(sizes))[:-1])).astype(np.int64)
    buf = np.empty(int(sum(s.sum() for s in sizes)), dtype=np.uint8)
    for part, size in zip(parts, sizes):
        if isinstance(part, bytes):
            for j, byte in enumerate(part):
                buf[at + j] = byte
        else:
            rows, _ = part
            col = np.arange(rows.shape[1])
            inside = col[None, :] < size[:, None]
            buf[(at[:, None] + col[None, :])[inside]] = rows[inside]
        at = at + size
    return buf.tobytes()


def fastq_bytes(seqs, quals, lengths, headers) -> bytes:
    """FASTQ records with the given header lines ('@' first, no newline)."""
    seqs, quals, lengths = (_numpy(x) for x in (seqs, quals, lengths))
    bases = np.frombuffer(DECODE, dtype=np.uint8)[seqs]
    n = len(lengths)
    return _records([_header_rows(headers), b"\n", (bases, lengths), b"\n+\n", (quals, lengths),
                     b"\n"], n)


def m3_streams(seqs, quals, lengths, headers) -> dict:
    """{".fq", ".fq.dna", ".fq.qs", ".h"}: the bytes of each for smoothed
    reads (base codes, ASCII qualities, lengths) and their header lines."""
    seqs, quals, lengths = (_numpy(x) for x in (seqs, quals, lengths))
    n = len(lengths)
    bases = np.frombuffer(DECODE, dtype=np.uint8)[seqs]
    return {
        ".fq": fastq_bytes(seqs, quals, lengths, headers),
        ".fq.dna": _records([(bases, lengths), b"\n"], n),
        ".fq.qs": _records([(quals, lengths), b"\n"], n),
        ".h": _records([_header_rows(headers), b"\n"], n),
    }

"""Alphabet codec for the EBWT pipeline (the port's copy of bfqzip_tpu/alphabet.py).

Codes are assigned in the collation order used throughout the pipeline, which is
the ASCII order of the reference's BWT alphabet {#, A, C, G, N, T}
(dna_bwt_n.hpp:46-61 builds its F-column in exactly this order):

    0 = TERM ('#')   the per-read end marker, smaller than every base
    1 = 'A'
    2 = 'C'
    3 = 'G'
    4 = 'N'
    5 = 'T'

The reference's smoothing core uses a different internal ordering for its
frequency arrays (ord: A->0 C->1 G->2 T->3 N->4, bfq_int.cpp:106-110); that
ordering is local to the smoothing maths and is handled inside ops/smooth.
"""

from __future__ import annotations

import numpy as np

TERM = 0
A, C, G, N, T = 1, 2, 3, 4, 5
SIGMA = 6  # alphabet size including TERM

TERM_CHAR = b"#"[0]

# byte value -> code (255 = invalid)
_ENCODE = np.full(256, 255, dtype=np.uint8)
for _c, _v in ((b"A", A), (b"C", C), (b"G", G), (b"N", N), (b"T", T), (b"#", TERM)):
    _ENCODE[_c[0]] = _v
# lower-case bases are accepted on input and normalised to upper case
for _c, _v in ((b"a", A), (b"c", C), (b"g", G), (b"n", N), (b"t", T)):
    _ENCODE[_c[0]] = _v

_DECODE = np.frombuffer(b"#ACGNT", dtype=np.uint8).copy()


def encode(ascii_bytes: np.ndarray) -> np.ndarray:
    """Map ASCII base bytes (u8) to codes (u8). Raises on non-ACGTN# input."""
    codes = _ENCODE[ascii_bytes]
    if codes.max(initial=0) == 255:
        bad = np.unique(ascii_bytes[codes == 255])
        raise ValueError(f"invalid base byte(s) in input: {[chr(b) for b in bad]}")
    return codes


def decode(codes: np.ndarray) -> np.ndarray:
    """Map codes (u8) back to ASCII base bytes (u8)."""
    return _DECODE[codes]

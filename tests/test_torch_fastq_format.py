"""The port's FASTQ serialiser on both of its routes, the native formatter
(native/fastq_codec.cpp) and the numpy scatter used without the library,
byte-equal to the JAX package's per-read format_fastq; `format_calls` says
which route ran.  Cases: every golden input with and without its headers,
mixed read lengths padded past the longest with a zero-length read, N
bases, a single read, and a bare '@' header among full ones."""

import glob
import os

import numpy as np
import pytest

from bfqzip_tpu.io import fastq as jax_fastq
from bfqzip_tpu_torch import alphabet
from bfqzip_tpu_torch.io import fastq
from bfqzip_tpu_torch.utils import native

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
INPUTS = sorted(os.path.basename(p) for p in glob.glob(os.path.join(GOLDEN, "*.in.fastq")))
_KEEP = object()  # format with the batch's own headers


def _reads(rows, width, seed):
    """(seqs, quals, lengths) of ASCII reads `rows`, padded with zeros to `width`."""
    rng = np.random.default_rng(seed)
    seqs = np.zeros((len(rows), width), np.uint8)
    quals = np.zeros((len(rows), width), np.uint8)
    for i, r in enumerate(rows):
        seqs[i, : len(r)] = alphabet.encode(np.frombuffer(r, np.uint8))
        quals[i, : len(r)] = rng.integers(33, 75, len(r))
    return seqs, quals, np.array([len(r) for r in rows], np.int32)


def _golden(name, headers):
    b = fastq.read_fastq(os.path.join(GOLDEN, name))
    return b.seqs, b.quals, b.lengths, b.headers, _KEEP if headers else None


def _case(name):
    if name.startswith("golden:"):
        _, fname, hdr = name.split(":")
        return _golden(fname, hdr == "headers")
    if name == "mixed_lengths_padded":
        s, q, n = _reads([b"ACGTACGTAC", b"", b"GATTACA", b"T", b"CCCCGGGGAAAATTTT"], 24, 1)
        return s, q, n, [b"@r%d" % i for i in range(5)], _KEEP
    if name == "n_bases":
        s, q, n = _reads([b"NNNN", b"ANCNGNTN", b"NACGTN"], 8, 2)
        return s, q, n, None, None
    if name == "single_read":
        s, q, n = _reads([b"GATTACAGATTACA"], 14, 3)
        return s, q, n, [b"@only read/1"], _KEEP
    if name == "bare_at_header":
        s, q, n = _reads([b"ACGT", b"TTGCA", b"G"], 6, 4)
        return s, q, n, [b"@first", b"@", b"@third one"], _KEEP
    raise KeyError(name)


CASES = [f"golden:{n}:{h}" for n in INPUTS for h in ("headers", "bare")] + [
    "mixed_lengths_padded", "n_bases", "single_read", "bare_at_header"]


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("case", CASES)
def test_format_fastq_byte_equal_to_jax(case, route, monkeypatch, tmp_path):
    if route == "native" and not native.available():
        pytest.skip("native library not built")
    if route == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
    seqs, quals, lengths, headers, which = _case(case)
    port = fastq.ReadBatch(seqs=seqs, quals=quals, lengths=lengths, headers=headers)
    ref = jax_fastq.ReadBatch(seqs=seqs, quals=quals, lengths=lengths, headers=headers)
    want = jax_fastq.format_fastq(ref) if which is _KEEP else jax_fastq.format_fastq(ref, headers=None)
    before = dict(fastq.format_calls)
    got = fastq.format_fastq(port) if which is _KEEP else fastq.format_fastq(port, headers=None)
    assert got == want
    assert fastq.format_calls[route] == before[route] + 1
    assert sum(fastq.format_calls.values()) == sum(before.values()) + 1
    path = tmp_path / "out.fq"
    fastq.write_fastq(str(path), port, headers if which is _KEEP else None)
    assert path.read_bytes() == want


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("fault", ["length_above_width", "negative_length", "too_few_headers"])
def test_format_fastq_refuses_what_it_cannot_lay_out(fault, route, monkeypatch):
    if route == "native" and not native.available():
        pytest.skip("native library not built")
    if route == "numpy":
        monkeypatch.setattr(native, "available", lambda: False)
    seqs, quals, lengths = _reads([b"ACGT", b"GGA"], 4, 5)
    headers = [b"@a", b"@b"]
    if fault == "length_above_width":
        lengths[1] = 5
    elif fault == "negative_length":
        lengths[1] = -1
    else:
        headers = headers[:1]
    with pytest.raises(ValueError):
        fastq.format_fastq(fastq.ReadBatch(seqs=seqs, quals=quals, lengths=lengths, headers=headers))


def test_native_formatter_refuses_a_code_outside_its_table():
    if not native.available():
        pytest.skip("native library not built")
    seqs, quals, lengths = _reads([b"ACGT"], 4, 6)
    seqs[0, 2] = alphabet.SIGMA
    with pytest.raises(ValueError, match="decode table"):
        native.fastq_format_array(seqs, quals, lengths, alphabet._DECODE)

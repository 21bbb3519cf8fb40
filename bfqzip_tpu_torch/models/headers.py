"""Tokenising codec for FASTQ header streams ("BQZH" containers), without jax.

Port of bfqzip_tpu/models/headers.py on the port's host coder
(bfqzip_tpu_torch.ops.rans); the containers are that module's byte for byte.

Illumina-style headers ("@ERR262997.120852 120852 length=101") are rigid
templates where only numeric fields vary.  The reference compresses the raw
header lines with PPMd/BSC (BFQzip.py:202,253-275); here headers are split
into alternating literal/numeric tokens, constant literals are stored once,
and numeric fields are delta-coded (then entropy-coded with the rANS
back end).  Falls back to plain byte coding when the token structure varies.

Container format (magic "BQZH"):
  u32 n_headers, u8 n_fields, then per field:
    kind 0 = constant literal: u32 len + bytes
    kind 1 = numeric: u8 width_flag(0 = no leading zeros; else fixed width),
             rANS blob of zigzag-varint deltas
    kind 2 = varying literal: rANS blob of '\n'-joined values
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np

from bfqzip_tpu_torch.ops import rans
from bfqzip_tpu_torch.utils.profiling import span

MAGIC = b"BQZH"
KINDS = ("constant", "numeric", "varying")  # field kinds 0, 1 and 2


def _zigzag(d: np.ndarray) -> np.ndarray:
    return ((d << 1) ^ (d >> 63)).astype(np.uint64)


def _unzigzag(z: np.ndarray) -> np.ndarray:
    return ((z >> 1).astype(np.int64)) ^ -(z & 1).astype(np.int64)


_MAX_VARINT_BYTES = 10  # ceil(64 / 7)


def _varint_encode(vals: np.ndarray) -> bytes:
    """LEB128 of u64 values, fully vectorised (no per-value Python loop)."""
    v = vals.astype(np.uint64)
    n = v.size
    if n == 0:
        return b""
    shifts = (np.uint64(7) * np.arange(_MAX_VARINT_BYTES, dtype=np.uint64))[None, :]
    groups = ((v[:, None] >> shifts) & np.uint64(0x7F)).astype(np.uint8)  # [n, 10]
    # bytes per value: index of the last nonzero 7-bit group, at least 1
    nz = groups != 0
    nbytes = np.where(nz.any(axis=1), _MAX_VARINT_BYTES - np.argmax(nz[:, ::-1], axis=1), 1)
    keep = np.arange(_MAX_VARINT_BYTES)[None, :] < nbytes[:, None]
    cont = np.arange(_MAX_VARINT_BYTES)[None, :] < (nbytes - 1)[:, None]
    out = np.where(cont, groups | 0x80, groups)
    return out[keep].tobytes()


def _varint_decode(data: np.ndarray, count: int) -> np.ndarray:
    """Inverse of _varint_encode, vectorised over the whole byte stream."""
    if count == 0:
        return np.zeros(0, np.uint64)
    b = np.asarray(data, np.uint8)
    term = (b & 0x80) == 0
    # value index of each byte; byte position within its value
    vid = np.zeros(b.size, np.int64)
    vid[1:] = np.cumsum(term.astype(np.int64))[:-1]
    starts = np.zeros(count, np.int64)
    ends = np.flatnonzero(term)
    if ends.size != count:
        raise ValueError("varint stream length mismatch")
    starts[1:] = ends[:-1] + 1
    pos = np.arange(b.size, dtype=np.int64) - starts[vid]
    vals = np.zeros(count, np.uint64)
    contrib = (b & np.uint8(0x7F)).astype(np.uint64) << (np.uint64(7) * pos.astype(np.uint64))
    np.bitwise_or.at(vals, vid, contrib)
    return vals


def encode_headers(headers: List[bytes]) -> bytes:
    """The BQZH container of the header lines (span `headers.encode`)."""
    with span("headers.encode"):
        return _encode_headers(headers)


def _tokens(headers: List[bytes]):
    """The headers' tokens (each header's runs of ASCII digits and of other
    bytes: the regex \\d+|\\D+) as [n, nf] arrays over the concatenated
    headers: (buf, starts, lengths, digit), digit[f] telling a column of
    digits; None where they are not uniform: the headers differ in their
    number of tokens, or a column mixes digit and non-digit tokens."""
    n = len(headers)
    buf = np.frombuffer(b"".join(headers), np.uint8)
    size = np.fromiter(map(len, headers), np.int64, n)
    first = np.zeros(n + 1, np.int64)
    np.cumsum(size, out=first[1:])
    is_digit = (buf >= ord("0")) & (buf <= ord("9"))
    edge = np.zeros(buf.size, bool)
    edge[1:] = is_digit[1:] != is_digit[:-1]
    edge[first[:-1][size > 0]] = True  # a token starts at each header's start
    starts = np.flatnonzero(edge)
    count = np.diff(np.searchsorted(starts, first))
    nf = int(count[0])
    if (count != nf).any():
        return None
    if nf == 0:  # every header empty
        none = np.zeros((n, 0), np.int64)
        return buf, none, none, np.zeros(0, bool)
    ends = np.append(starts[1:], buf.size).reshape(n, nf)
    starts = starts.reshape(n, nf)
    digit = is_digit[starts]
    if (digit != digit[:1]).any():
        return None
    return buf, starts, ends - starts, digit[0]


def _numbers(buf: np.ndarray, starts: np.ndarray, lengths: np.ndarray, width: int) -> np.ndarray:
    """The values of digit tokens of at most `width` (<= 18) digits."""
    vals = np.zeros(starts.size, np.int64)
    for j in range(width):
        inside = j < lengths
        digit = buf[np.where(inside, starts + j, 0)].astype(np.int64) - ord("0")
        vals = np.where(inside, vals * 10 + digit, vals)
    return vals


def _encode_headers(headers: List[bytes]) -> bytes:
    n = len(headers)
    toks = _tokens(headers) if n else None
    if toks is None:
        blob = rans.encode_blob_best(b"\n".join(headers) + b"\n" if n else b"")
        return MAGIC + struct.pack("<IB", n, 255) + blob

    buf, starts, lengths, digit = toks
    parts = [MAGIC + struct.pack("<IB", n, len(digit))]
    for f in range(len(digit)):
        s, ln = starts[:, f], lengths[:, f]
        # leading zeros only survive a fixed-width (%0*d) re-rendering, and
        # int64 delta coding needs values < 2^63: any column with varying
        # widths + a leading zero, or an over-long value, takes the literal
        # kind-2 path (lossless by construction)
        numeric_ok = bool(digit[f])
        if numeric_ok:
            width = int(ln.max())
            fixed = width if int(ln.min()) == width else None
            has_lz = bool(((buf[s] == ord("0")) & (ln > 1)).any())
            if (has_lz and fixed is None) or width > 18:
                numeric_ok = False
        if numeric_ok:
            width_flag = (fixed or 0) if has_lz else 0
            vals = _numbers(buf, s, ln, width)
            deltas = np.empty_like(vals)
            deltas[0] = vals[0]
            deltas[1:] = vals[1:] - vals[:-1]
            payload = _varint_encode(_zigzag(deltas))
            blob = rans.encode_blob_best(payload)
            parts.append(struct.pack("<BBI", 1, width_flag, len(blob)) + blob)
        elif (ln == ln[0]).all() and all((buf[s + j] == buf[s[0] + j]).all() for j in range(int(ln[0]))):
            parts.append(struct.pack("<BI", 0, int(ln[0])) + buf[s[0] : s[0] + ln[0]].tobytes())
        else:
            data = buf.tobytes()
            joined = b"\n".join(data[a : a + k] for a, k in zip(s.tolist(), ln.tolist()))
            blob = rans.encode_blob_best(joined)
            parts.append(struct.pack("<BI", 2, len(blob)) + blob)
    return b"".join(parts)


def field_kinds(blob: bytes) -> dict:
    """A BQZH container's fields counted by kind (KINDS), read from its
    field headers; {"fallback": 1} for the non-uniform fallback's one blob."""
    nf = blob[8]
    if nf == 255:
        return {"fallback": 1}
    counts = dict.fromkeys(KINDS, 0)
    off = 9
    for _ in range(nf):
        kind = blob[off]
        counts[KINDS[kind]] += 1
        size_at = off + (2 if kind == 1 else 1)  # a numeric field has a width byte first
        (size,) = struct.unpack_from("<I", blob, size_at)
        off = size_at + 4 + size
    return counts


def decode_headers(blob: bytes) -> List[bytes]:
    if blob[:4] != MAGIC:
        raise ValueError("not a bfqzip header container")
    n, nf = struct.unpack_from("<IB", blob, 4)
    off = 9
    if nf == 255:  # non-uniform fallback
        data = bytes(rans.decode_blob(blob[off:]))
        return data.split(b"\n")[:n]
    cols = []
    for _ in range(nf):
        kind = blob[off]
        if kind == 0:
            (length,) = struct.unpack_from("<I", blob, off + 1)
            lit = blob[off + 5 : off + 5 + length]
            off += 5 + length
            cols.append([lit] * n)
        elif kind == 1:
            width_flag, blen = struct.unpack_from("<BI", blob, off + 1)
            payload = bytes(rans.decode_blob(blob[off + 6 : off + 6 + blen]))
            off += 6 + blen
            deltas = _unzigzag(_varint_decode(np.frombuffer(payload, np.uint8), n))
            vals = np.cumsum(deltas)
            if width_flag:
                cols.append([b"%0*d" % (width_flag, v) for v in vals])
            else:
                cols.append([b"%d" % v for v in vals])
        elif kind == 2:
            (blen,) = struct.unpack_from("<I", blob, off + 1)
            joined = bytes(rans.decode_blob(blob[off + 5 : off + 5 + blen]))
            off += 5 + blen
            cols.append(joined.split(b"\n"))
        else:
            raise ValueError(f"bad field kind {kind}")
    return [b"".join(cols[f][i] for f in range(nf)) for i in range(n)]

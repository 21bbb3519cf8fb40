"""FASTQ I/O: parse into fixed-shape arrays, serialise back (the port's copy
of bfqzip_tpu/io/fastq.py, without its XLA compile-shape buckets).

The reference streams FASTQ through `sed` process boundaries (BFQzip.py:19-21)
and getline loops (bfq_int.cpp:800-806); here a FASTQ file becomes a `ReadBatch`
of dense arrays ready for device transfer:

    seqs    [N, L] u8   base codes (alphabet.py), zero-padded past each read
    quals   [N, L] u8   raw ASCII quality bytes, zero-padded
    lengths [N]    i32  read lengths
    headers list[bytes] the '@' header lines (without trailing newline)

A native C++ parser (native/fastq_codec.cpp) is used when available; the numpy
fallback below is vectorised and handles multi-hundred-MB files acceptably.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from bfqzip_tpu_torch import alphabet


@dataclasses.dataclass
class ReadBatch:
    seqs: np.ndarray  # [N, L] u8 codes
    quals: np.ndarray  # [N, L] u8 raw ASCII
    lengths: np.ndarray  # [N] i32
    headers: Optional[List[bytes]] = None

    @property
    def num_reads(self) -> int:
        return int(self.seqs.shape[0])

    @property
    def max_len(self) -> int:
        return int(self.seqs.shape[1])

    @property
    def total_bases(self) -> int:
        return int(self.lengths.sum())

    def validate(self) -> None:
        if self.seqs.shape != self.quals.shape:
            raise ValueError("seqs/quals shape mismatch")
        if self.lengths.shape[0] != self.seqs.shape[0]:
            raise ValueError("lengths/seqs shape mismatch")
        if self.lengths.max(initial=0) > self.seqs.shape[1]:
            raise ValueError("read longer than padded width")


def _split_records(data: bytes):
    """Split raw FASTQ bytes into line-index arrays.

    Returns (starts, ends) of every line, vectorised via newline scan.
    """
    buf = np.frombuffer(data, dtype=np.uint8)
    if buf.size == 0:
        raise ValueError("empty FASTQ")
    nl = np.flatnonzero(buf == ord("\n"))
    # tolerate a missing final newline
    if nl.size == 0 or nl[-1] != buf.size - 1:
        nl = np.append(nl, buf.size)
    starts = np.concatenate(([0], nl[:-1] + 1))
    ends = nl
    # drop trailing blank lines
    keep = ends > starts
    if not keep.all():
        # only trailing blanks are tolerated
        nonblank = np.flatnonzero(keep)
        if nonblank.size and (np.diff(nonblank) != 1).any():
            raise ValueError("blank line inside FASTQ")
        starts, ends = starts[keep], ends[keep]
    return buf, starts, ends


def read_fastq(path: str, with_headers: bool = True, max_len: Optional[int] = None) -> ReadBatch:
    """Read a FASTQ file (gzip-compressed inputs are detected by magic)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\x1f\x8b":
        import gzip

        data = gzip.decompress(data)
    return parse_fastq(data, with_headers=with_headers, max_len=max_len)


def parse_fastq(data: bytes, with_headers: bool = True, max_len: Optional[int] = None) -> ReadBatch:
    """Parse FASTQ bytes; uses the native C++ parser when built, else numpy."""
    from bfqzip_tpu_torch.utils import native

    if native.available() and max_len is None:
        try:
            res = native.fastq_parse(data, alphabet._ENCODE)
        except ValueError:
            # fall through for the python path's error messages
            return _parse_fastq_np(data, with_headers, max_len)
        if res is not None:
            seqs, quals, lengths, hoff, hlen = res
            headers = None
            if with_headers:
                headers = [data[o : o + l] for o, l in zip(hoff, hlen)]
            return ReadBatch(seqs=seqs, quals=quals, lengths=lengths, headers=headers)
    return _parse_fastq_np(data, with_headers, max_len)


def _parse_fastq_np(data: bytes, with_headers: bool = True, max_len: Optional[int] = None) -> ReadBatch:
    buf, starts, ends = _split_records(data)
    nlines = starts.size
    if nlines % 4 != 0:
        raise ValueError(f"FASTQ line count {nlines} not a multiple of 4")
    n = nlines // 4

    seq_s, seq_e = starts[1::4], ends[1::4]
    qs_s, qs_e = starts[3::4], ends[3::4]
    lengths = (seq_e - seq_s).astype(np.int64)
    if not (lengths == (qs_e - qs_s)).all():
        bad = int(np.flatnonzero(lengths != (qs_e - qs_s))[0])
        raise ValueError(f"record {bad}: DNA/quality length mismatch")
    if (buf[starts[0::4]] != ord("@")).any():
        raise ValueError("malformed FASTQ: header line not starting with '@'")

    lmax = int(lengths.max(initial=0))
    width = max_len if max_len is not None else lmax
    if lmax > width:
        raise ValueError(f"read length {lmax} exceeds max_len {width}")

    # gather rows: seq row i = buf[seq_s[i] : seq_s[i]+len[i]], vectorised
    offs = np.arange(width, dtype=np.int64)
    idx = seq_s[:, None] + offs[None, :]
    mask = offs[None, :] < lengths[:, None]
    np.minimum(idx, buf.size - 1, out=idx)
    seq_ascii = np.where(mask, buf[idx], 0).astype(np.uint8)
    qidx = qs_s[:, None] + offs[None, :]
    np.minimum(qidx, buf.size - 1, out=qidx)
    quals = np.where(mask, buf[qidx], 0).astype(np.uint8)

    seqs = np.zeros_like(seq_ascii)
    seqs[mask] = alphabet.encode(seq_ascii[mask])

    headers = None
    if with_headers:
        hs, he = starts[0::4], ends[0::4]
        headers = [bytes(buf[s:e]) for s, e in zip(hs, he)]

    return ReadBatch(seqs=seqs, quals=quals, lengths=lengths.astype(np.int32), headers=headers)


_USE_BATCH = object()


def format_fastq(batch: ReadBatch, headers=_USE_BATCH) -> bytes:
    """Serialise a ReadBatch to FASTQ bytes.

    `headers=None` forces bare '@' lines like the reference's header-less mode
    (bfq_int.cpp:758,805); by default the batch's own headers are used.
    """
    hdrs = batch.headers if headers is _USE_BATCH else headers
    n, width = batch.seqs.shape
    lengths = batch.lengths.astype(np.int64)

    seq_ascii = alphabet.decode(batch.seqs)
    out = []
    # row-wise assembly via one big buffer: compute record offsets first
    hlens = np.fromiter(
        (len(h) for h in hdrs) if hdrs is not None else (1 for _ in range(n)),
        dtype=np.int64,
        count=n,
    )
    rec_lens = hlens + 1 + (lengths + 1) + 2 + (lengths + 1)
    total = int(rec_lens.sum())
    buf = np.empty(total, dtype=np.uint8)
    pos = 0
    nl = ord("\n")
    for i in range(n):
        L = int(lengths[i])
        h = hdrs[i] if hdrs is not None else b"@"
        hl = len(h)
        buf[pos : pos + hl] = np.frombuffer(h, dtype=np.uint8)
        pos += hl
        buf[pos] = nl
        pos += 1
        buf[pos : pos + L] = seq_ascii[i, :L]
        pos += L
        buf[pos] = nl
        pos += 1
        buf[pos] = ord("+")
        buf[pos + 1] = nl
        pos += 2
        buf[pos : pos + L] = batch.quals[i, :L]
        pos += L
        buf[pos] = nl
        pos += 1
    assert pos == total
    out.append(buf.tobytes())
    return b"".join(out)


def write_fastq(path: str, batch: ReadBatch, headers: Optional[List[bytes]] = None) -> None:
    with open(path, "wb") as f:
        f.write(format_fastq(batch, headers))

"""FASTQ I/O: parse into fixed-shape arrays, serialise back (the port's copy
of bfqzip_tpu/io/fastq.py, without its XLA compile-shape buckets).

The reference streams FASTQ through `sed` process boundaries (BFQzip.py:19-21)
and getline loops (bfq_int.cpp:800-806); here a FASTQ file becomes a `ReadBatch`
of dense arrays ready for device transfer:

    seqs    [N, L] u8   base codes (alphabet.py), zero-padded past each read
    quals   [N, L] u8   raw ASCII quality bytes, zero-padded
    lengths [N]    i32  read lengths
    headers list[bytes] the '@' header lines (without trailing newline)

The native C++ parser and formatter (native/fastq_codec.cpp) are used when
available; the numpy fallbacks below are vectorised and handle
multi-hundred-MB files acceptably.
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

# the route each fastq_array call took: the native formatter, or numpy without it
format_calls = {"native": 0, "numpy": 0}


def fastq_array(batch: ReadBatch, headers=_USE_BATCH) -> np.ndarray:
    """Serialise a ReadBatch to FASTQ bytes, as a u8 array.

    `headers=None` forces bare '@' lines like the reference's header-less mode
    (bfq_int.cpp:758,805); by default the batch's own headers are used.  The
    native formatter (native/fastq_codec.cpp) writes them when it is built,
    else vectorised numpy.
    """
    from bfqzip_tpu_torch.utils import native

    hdrs = batch.headers if headers is _USE_BATCH else headers
    n = batch.num_reads
    blob = hoff = hlens = None
    if hdrs is not None:
        if len(hdrs) != n:
            raise ValueError(f"{len(hdrs)} headers for {n} reads")
        blob = b"".join(hdrs)
        hlens = np.fromiter(map(len, hdrs), dtype=np.int64, count=n)
        hoff = np.zeros(n, dtype=np.int64)
        np.cumsum(hlens[:-1], out=hoff[1:])
    if native.available():
        format_calls["native"] += 1
        return native.fastq_format_array(batch.seqs, batch.quals, batch.lengths, alphabet._DECODE,
                                         blob, hoff, hlens)
    format_calls["numpy"] += 1
    if hdrs is None:
        blob, hoff, hlens = b"@" * n, np.arange(n, dtype=np.int64), np.ones(n, dtype=np.int64)
    return _format_fastq_np(batch, blob, hoff, hlens)


def _format_fastq_np(batch: ReadBatch, blob: bytes, hoff: np.ndarray, hlens: np.ndarray) -> np.ndarray:
    """fastq_array without the library: every byte scattered to its place
    from the record offsets, one index array a field."""
    n, width = batch.seqs.shape
    lengths = batch.lengths.astype(np.int64)
    if n and (lengths.min() < 0 or lengths.max() > width):
        raise ValueError(f"read lengths must lie in [0, {width}]")
    rec_lens = hlens + 1 + (lengths + 1) + 2 + (lengths + 1)
    rec_start = np.zeros(n, dtype=np.int64)
    np.cumsum(rec_lens[:-1], out=rec_start[1:])
    out = np.empty(int(rec_lens.sum()), dtype=np.uint8)
    out[np.repeat(rec_start - hoff, hlens) + np.arange(len(blob))] = np.frombuffer(blob, dtype=np.uint8)
    seq_start = rec_start + hlens + 1
    out[seq_start - 1] = ord("\n")
    body = np.arange(width) < lengths[:, None]
    base_start = np.zeros(n, dtype=np.int64)  # each read's first base among all reads' bases
    np.cumsum(lengths[:-1], out=base_start[1:])
    at = np.repeat(seq_start - base_start, lengths) + np.arange(int(lengths.sum()))
    out[at] = alphabet.decode(batch.seqs)[body]
    qual_start = seq_start + lengths + 3
    out[qual_start - 3] = out[qual_start - 1] = ord("\n")
    out[qual_start - 2] = ord("+")
    at += np.repeat(lengths + 3, lengths)
    out[at] = batch.quals[body]
    out[qual_start + lengths] = ord("\n")
    return out


def format_fastq(batch: ReadBatch, headers=_USE_BATCH) -> bytes:
    """fastq_array's bytes (same arguments)."""
    return fastq_array(batch, headers).tobytes()


def write_fastq(path: str, batch: ReadBatch, headers: Optional[List[bytes]] = None) -> None:
    with open(path, "wb") as f:
        f.write(fastq_array(batch, headers))

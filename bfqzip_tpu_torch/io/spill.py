"""File-backed scratch arrays with explicit residency control (the port's
copy of bfqzip_tpu/io/spill.py).

The reference's external-memory engine keeps its big state in pile files and
cyc files on disk, touching only small buffers in RAM
(src_ext_mem/bfq_ext.cpp:190-348, decode.cpp:409-496).  The TPU-native
analog: every O(n) host array of the out-of-core pipeline lives in an
np.memmap inside a scratch directory, and ranges that a stage has finished
writing or consuming are explicitly evicted (msync + MADV_DONTNEED), so the
process's resident set stays bounded by the active working set while the
page cache absorbs — and can reclaim — everything else.

MADV_DONTNEED on a MAP_SHARED file mapping drops the process's resident
pages without discarding data (dirty pages belong to the file's page cache
and are preserved); a later access faults them back in.
"""

from __future__ import annotations

import atexit
import mmap
import os
import shutil
import tempfile
import threading
from typing import Dict, Optional, Tuple

import numpy as np

_PAGE = mmap.PAGESIZE


class Spill:
    """A scratch directory of named memmap arrays."""

    def __init__(self, dir: Optional[str] = None, keep: bool = False):
        base = dir or os.environ.get("BFQ_SPILL_DIR") or None
        self.dir = tempfile.mkdtemp(prefix="bfqspill_", dir=base)
        self.keep = keep
        self._arrays: Dict[str, np.memmap] = {}
        self._closed = False
        atexit.register(self.close)

    def alloc(self, name: str, shape: Tuple[int, ...], dtype) -> np.memmap:
        """Create (or replace) a named file-backed array."""
        path = os.path.join(self.dir, name)
        mm = np.memmap(path, dtype=dtype, mode="w+", shape=shape)
        self._arrays[name] = mm
        return mm

    @staticmethod
    def evict(arr: np.ndarray, start: int = 0, length: Optional[int] = None) -> None:
        """Drop the resident pages of a memmap byte range.

        start/length are in BYTES into the mapping; the range is widened to
        page boundaries.  A no-op for non-memmap arrays (the in-RAM path
        shares the calling code).

        No msync: for a MAP_SHARED file mapping MADV_DONTNEED only drops the
        process's PTEs — dirty pages stay in the file's page cache (written
        back lazily by the kernel) and fault straight back on access.  An
        explicit flush here turned the merge watcher into a writeback storm
        that lagged eviction behind the writer (measured 12.7GB resident at
        the 10M-read merge vs ~3GB without it).
        """
        mm = getattr(arr, "_mmap", None)
        if mm is None:
            return
        total = len(mm)
        if length is None:
            length = total - start
        lo = (start // _PAGE) * _PAGE
        hi = min(-(-(start + length) // _PAGE) * _PAGE, total)
        if hi <= lo:
            return
        try:
            mm.madvise(mmap.MADV_DONTNEED, lo, hi - lo)
        except (OSError, ValueError, AttributeError):  # pragma: no cover
            pass

    def evict_all(self, *names: str) -> None:
        for name in names or list(self._arrays):
            arr = self._arrays.get(name)
            if arr is not None:
                self.evict(arr)

    def drop(self, name: str) -> None:
        """Delete a scratch array and its file entirely."""
        arr = self._arrays.pop(name, None)
        if arr is not None:
            mm = getattr(arr, "_mmap", None)
            del arr
            if mm is not None:
                try:
                    mm.close()
                except (BufferError, OSError):  # a view still references it
                    pass
            try:
                os.unlink(os.path.join(self.dir, name))
            except OSError:
                pass

    def watcher(self, *names: str, interval: float = 1.0) -> "_Watcher":
        """Context manager: a thread that periodically evicts the named
        arrays while a long native call (the k-way merge) streams through
        them — the merge's active windows fault straight back from page
        cache, and the process RSS stays bounded."""
        return _Watcher(self, names, interval)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._arrays.clear()
        if not self.keep:
            shutil.rmtree(self.dir, ignore_errors=True)


class _Watcher:
    def __init__(self, spill: Spill, names, interval: float):
        self.spill = spill
        self.names = names
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def __enter__(self):
        def run():
            while not self._stop.wait(self.interval):
                self.spill.evict_all(*self.names)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
        return False


def read_fastq_spill(path: str, spill: Spill, with_headers: bool = False,
                     slab_bytes: int = 256 << 20):
    """Streaming FASTQ parse into spill-backed [N, L] arrays.

    The whole-file reader (io.fastq.read_fastq) holds file bytes + both
    output arrays resident at once (~4.4 B/base transient at 10M reads);
    this maps the file, scans it once for (n_reads, max_len), then parses
    record-aligned slabs of ~slab_bytes, evicting each slab's file pages and
    output rows as it goes — peak residency is one slab.

    Returns a ReadBatch whose seqs/quals are memmaps in `spill`.
    """
    from bfqzip_tpu_torch import alphabet
    from bfqzip_tpu_torch.io.fastq import ReadBatch, read_fastq
    from bfqzip_tpu_torch.utils import native

    if not native.available():
        return read_fastq(path, with_headers=with_headers)  # pragma: no cover
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":  # gzip: no random access, fall back
        return read_fastq(path, with_headers=with_headers)

    data = np.memmap(path, dtype=np.uint8, mode="r")
    lib = native._find_lib()
    import ctypes

    # ---- pass 1: record-aligned slab boundaries + global (N, W) ----
    # each slab ends just after a newline whose cumulative count within the
    # slab is a multiple of 4 — i.e. a whole number of 4-line records
    slabs = []  # (byte_lo, byte_hi)
    cur = 0
    size = data.size
    while cur < size:
        hi = min(cur + slab_bytes, size)
        if hi < size:
            nls = np.flatnonzero(data[cur:hi] == ord(b"\n"))
            m = (nls.size // 4) * 4
            if m == 0:
                raise ValueError("FASTQ record larger than the slab size")
            hi = cur + int(nls[m - 1]) + 1
        slabs.append((cur, hi))
        cur = hi

    n_reads = 0
    max_len = 0
    counts = []
    for lo, hi in slabs:
        nr = ctypes.c_int64()
        ml = ctypes.c_int64()
        buf = data[lo:hi]
        rc = lib.fastq_scan(native._ptr(buf), hi - lo, ctypes.byref(nr), ctypes.byref(ml))
        if rc != 0:
            raise ValueError(f"malformed FASTQ (native scan rc={rc}, slab @{lo})")
        counts.append(nr.value)
        n_reads += nr.value
        max_len = max(max_len, ml.value)
        Spill.evict(data, lo, hi - lo)
    if n_reads == 0:
        raise ValueError("empty FASTQ")

    # ---- pass 2: fill spill-backed arrays slab by slab ----
    seqs = spill.alloc("in_seqs", (n_reads, max_len), np.uint8)
    quals = spill.alloc("in_quals", (n_reads, max_len), np.uint8)
    lengths = np.zeros(n_reads, np.int32)
    headers = [] if with_headers else None
    row = 0
    for (lo, hi), nr in zip(slabs, counts):
        if nr == 0:
            continue
        buf = data[lo:hi]
        hoff = np.zeros(nr, np.int64)
        hlen = np.zeros(nr, np.int64)
        rc = lib.fastq_fill(
            native._ptr(buf), hi - lo, native._ptr(alphabet._ENCODE),
            max_len,
            native._ptr(seqs[row : row + nr]), native._ptr(quals[row : row + nr]),
            native._ptr(lengths[row : row + nr]), native._ptr(hoff), native._ptr(hlen),
        )
        if rc != 0:
            raise ValueError(f"invalid FASTQ content (native fill rc={rc}, slab @{lo})")
        if headers is not None:
            hbytes = buf.tobytes()
            headers.extend(hbytes[o : o + l] for o, l in zip(hoff, hlen))
        Spill.evict(data, lo, hi - lo)
        Spill.evict(seqs, row * max_len, nr * max_len)
        Spill.evict(quals, row * max_len, nr * max_len)
        row += nr
    del data
    return ReadBatch(seqs=seqs, quals=quals, lengths=lengths, headers=headers)

"""ctypes bindings for the native C++ runtime.

The port's copy of the codec and FASTQ bindings of
bfqzip_tpu/utils/native.py, with the same signatures.  FASTQ parsing and
formatting and the rANS and BQZC codecs load the shared library that
`make -C native` builds in the repository's native/ directory (at first
use, if it is missing); FASTQ parsing and formatting and the rANS coder
have numpy fallbacks, so the package works without it, and BQZC needs it.  The
out-of-core k-way merge is the port's own, csrc/extmerge.cpp, built by
utils/cuda_build with the host compiler at first use: ext_merge runs it
while the caller waits, ext_merge_async on a thread whose merged prefix a
consumer reads while it runs.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
import time
from typing import Optional

import numpy as np

from bfqzip_tpu_torch.utils import cuda_build

_LIB = None
_SEARCHED = False
_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native"
)


def _autobuild() -> None:
    """Build the shared library in place if the toolchain is available
    (fresh checkouts).  Failures are silent: the callers fall back or raise."""
    import subprocess

    try:
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True, capture_output=True, timeout=120)
    except Exception:
        pass


def _find_lib():
    global _LIB, _SEARCHED
    if _SEARCHED:
        return _LIB
    _SEARCHED = True
    path = os.path.join(_NATIVE_DIR, "libbfqnative.so")
    if not os.path.exists(path) and os.path.exists(os.path.join(_NATIVE_DIR, "Makefile")):
        _autobuild()
    if not os.path.exists(path):
        return None
    # A corrupt or stale .so (failed link, ABI mismatch, a missing entry
    # point) must degrade to the numpy path, not crash the import.
    try:
        lib = ctypes.CDLL(path)
        # Every size/length parameter is int64 on the C side; without
        # argtypes, ctypes passes python ints as 32-bit, and a >2GB FASTQ
        # once truncated to a NEGATIVE size.  Declare all signatures.
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.fastq_scan.restype = i32
        lib.fastq_scan.argtypes = [vp, i64, vp, vp]
        lib.fastq_fill.restype = i32
        lib.fastq_fill.argtypes = [vp, i64, vp, i64, vp, vp, vp, vp, vp]
        lib.fastq_format.restype = i64
        lib.fastq_format.argtypes = [vp, vp, vp, i64, i64, vp, vp, vp, vp, vp]
        lib.rans_encode.restype = i64
        lib.rans_encode.argtypes = [vp, i64, i32, i32, vp, i64]
        lib.rans_decode.restype = i64
        lib.rans_decode.argtypes = [vp, i64, vp, i64]
        lib.cm_encode_blocked.restype = i64
        lib.cm_encode_blocked.argtypes = [vp, i64, vp, i64, i64, i32, i32]
        lib.cm_decode.restype = i64
        lib.cm_decode.argtypes = [vp, i64, vp, i64]
    except (OSError, AttributeError):
        return None
    _LIB = lib
    return _LIB


def available() -> bool:
    return _find_lib() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def fastq_parse(data: bytes, code_map: np.ndarray):
    """Parse FASTQ bytes -> (seqs, quals, lengths, header_off, header_len).
    Returns None if the native library is unavailable."""
    lib = _find_lib()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    n_reads = ctypes.c_int64()
    max_len = ctypes.c_int64()
    rc = lib.fastq_scan(_ptr(buf), len(data), ctypes.byref(n_reads), ctypes.byref(max_len))
    if rc != 0:
        raise ValueError(f"malformed FASTQ (native scan rc={rc})")
    n, w = n_reads.value, max_len.value
    seqs = np.zeros((n, w), np.uint8)
    quals = np.zeros((n, w), np.uint8)
    lengths = np.zeros(n, np.int32)
    hoff = np.zeros(n, np.int64)
    hlen = np.zeros(n, np.int64)
    rc = lib.fastq_fill(_ptr(buf), len(data), _ptr(code_map), w,
                        _ptr(seqs), _ptr(quals), _ptr(lengths), _ptr(hoff), _ptr(hlen))
    if rc != 0:
        raise ValueError(f"invalid FASTQ content (native fill rc={rc})")
    return seqs, quals, lengths, hoff, hlen


def fastq_format(seqs, quals, lengths, decode_map, headers_blob=None, hoff=None,
                 hlen=None) -> Optional[bytes]:
    """FASTQ bytes of padded [N, L] reads (native/fastq_codec.cpp): code ->
    ASCII through decode_map; each header is headers_blob[hoff:hoff + hlen]
    (the offsets fastq_parse returns), or a bare '@' without headers_blob.
    Returns None if the native library is unavailable."""
    out = fastq_format_array(seqs, quals, lengths, decode_map, headers_blob, hoff, hlen)
    return None if out is None else out.tobytes()


def fastq_format_array(seqs, quals, lengths, decode_map, headers_blob=None, hoff=None,
                       hlen=None) -> Optional[np.ndarray]:
    """fastq_format's bytes as a u8 array, without the copy into bytes (a
    file's write takes the array as it is).  Raises ValueError on a length
    outside [0, L], a code outside decode_map or a header outside the blob."""
    lib = _find_lib()
    if lib is None:
        return None
    n, w = seqs.shape
    if quals.shape != seqs.shape or len(lengths) != n:
        raise ValueError("seqs, quals and lengths disagree in shape")
    lengths64 = np.asarray(lengths, np.int64)
    if n and (lengths64.min() < 0 or lengths64.max() > w):
        raise ValueError(f"read lengths must lie in [0, {w}]")
    if seqs.size and int(seqs.max()) >= len(decode_map):
        raise ValueError(f"base code {int(seqs.max())} outside the decode table")
    hb = hoff64 = hlen64 = None
    hsize = n  # a bare '@' a read
    if headers_blob is not None:
        hb = np.frombuffer(headers_blob, np.uint8)
        hoff64, hlen64 = np.ascontiguousarray(hoff, np.int64), np.ascontiguousarray(hlen, np.int64)
        if hoff64.shape != (n,) or hlen64.shape != (n,):
            raise ValueError("header offsets and lengths need one entry a read")
        if n and (hoff64.min() < 0 or hlen64.min() < 0 or (hoff64 + hlen64).max() > hb.size):
            raise ValueError("header offsets outside the header blob")
        hsize = int(hlen64.sum())
    total = int(hsize + 5 * n + 2 * lengths64.sum())  # "\n", "\n+\n", "\n" a read
    out = np.empty(total, np.uint8)
    # each converted array is named, so it lives until the call returns
    seqs_c, quals_c = np.ascontiguousarray(seqs, np.uint8), np.ascontiguousarray(quals, np.uint8)
    lens32 = np.ascontiguousarray(lengths, np.int32)
    dmap = np.ascontiguousarray(decode_map, np.uint8)
    written = lib.fastq_format(
        _ptr(seqs_c), _ptr(quals_c), _ptr(lens32), n, w, _ptr(dmap),
        _ptr(hb) if hb is not None else None,
        _ptr(hoff64) if hoff64 is not None else None,
        _ptr(hlen64) if hlen64 is not None else None,
        _ptr(out),
    )
    if written != total:
        raise RuntimeError(f"native fastq_format rc={written} (expected {total})")
    return out


def rans_encode(data: bytes, spec_order: int, lanes: int) -> Optional[bytes]:
    lib = _find_lib()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    cap = len(data) * 2 + (1 << 20)
    out = np.zeros(cap, np.uint8)
    size = lib.rans_encode(_ptr(buf), len(data), spec_order, lanes, _ptr(out), cap)
    if size < 0:
        raise RuntimeError(f"native rans_encode rc={size}")
    return out[:size].tobytes()


def rans_decode(blob: bytes) -> Optional[np.ndarray]:
    lib = _find_lib()
    if lib is None:
        return None
    buf = np.frombuffer(blob, np.uint8)
    n = lib.rans_decode(_ptr(buf), len(blob), None, 0)
    if n < 0:
        raise ValueError(f"native rans_decode rc={n}")
    out = np.zeros(int(n), np.uint8)
    rc = lib.rans_decode(_ptr(buf), len(blob), _ptr(out), int(n))
    if rc < 0:
        raise ValueError(f"native rans_decode rc={rc}")
    return out


def cm_available() -> bool:
    return _find_lib() is not None


def cm_encode(
    data: bytes, block_size: int = 0, threads: int = 0, pos_reset: int = -1,
    profile: Optional[str] = None,
) -> Optional[bytes]:
    """Adaptive context-model coder (native/cm_codec.cpp, magic BQZC), in
    its blocked container: independent per-block models, encoded and decoded
    on a thread pool.  block_size <= 0 picks the 16M-symbol default, threads
    <= 0 one per core (BFQ_CM_THREADS overrides).  pos_reset >= 0 enables
    the positional context model with that byte restarting the in-record
    position counter (pass ord('\\n') for line-structured streams like
    .fq.qs).  profile ('fast' | 'max'; None: BFQ_CM_PROFILE, else 'max')
    picks the speed/ratio point: 'fast' drops the reverse-complement and
    high-order models for a faster decode at a ratio cost."""
    lib = _find_lib()
    if lib is None:
        return None
    if profile is not None:
        if profile not in ("fast", "max"):
            raise ValueError(f"profile must be 'fast' or 'max', got {profile!r}")
        old = os.environ.get("BFQ_CM_PROFILE")
        os.environ["BFQ_CM_PROFILE"] = profile
        try:
            return cm_encode(data, block_size, threads, pos_reset)
        finally:
            if old is None:
                os.environ.pop("BFQ_CM_PROFILE", None)
            else:
                os.environ["BFQ_CM_PROFILE"] = old
    buf = np.frombuffer(data, np.uint8)
    # the container carries a 4-byte length per block: the capacity follows
    # the actual block count, so a tiny block_size cannot overflow it
    block = block_size if block_size > 0 else 16 * 1024 * 1024
    cap = len(data) + len(data) // 2 + (1 << 16) + 4 * (max(len(data) + block - 1, 1) // block) + 64
    out = np.zeros(cap, np.uint8)
    size = lib.cm_encode_blocked(_ptr(buf), len(data), _ptr(out), cap, ctypes.c_int64(block_size),
                                 ctypes.c_int(threads), ctypes.c_int(pos_reset))
    if size < 0:
        raise RuntimeError(f"native cm_encode rc={size}")
    return out[:size].tobytes()


def cm_decode(blob: bytes) -> Optional[np.ndarray]:
    lib = _find_lib()
    if lib is None:
        return None
    buf = np.frombuffer(blob, np.uint8)
    n = lib.cm_decode(_ptr(buf), len(blob), None, 0)
    if n < 0:
        raise ValueError(f"native cm_decode rc={n}")
    out = np.zeros(int(n), np.uint8)
    rc = lib.cm_decode(_ptr(buf), len(blob), _ptr(out), int(n))
    if rc < 0:
        raise ValueError(f"native cm_decode rc={rc}")
    return out


# ---- the out-of-core k-way merge (csrc/extmerge.cpp) ----

_MERGE = None
# the emits between two progress publishes of a live merge
PROGRESS_STEP = 1 << 18
# the merged-prefix marks ExtMergeHandle.prefix_s times, as fractions of the total
PREFIX_MARKS = (0.25, 0.5, 0.75, 1.0)


def _merge_lib():
    """The port's merge library, built at first use; raises if it cannot be."""
    global _MERGE
    if _MERGE is None:
        lib = cuda_build.load("extmerge")
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        serial = [vp, vp, i64, vp, vp, vp, i32, vp, vp, vp, vp, vp, i32, i32]
        for name, args in (("ext_merge_mt2", serial), ("ext_merge_mt3", serial),
                           ("ext_merge_mt2p", serial + [vp, i64]),
                           ("ext_merge_mt3p", serial + [vp, i64])):
            fn = getattr(lib, name)
            fn.restype = i64
            fn.argtypes = args
        lib.ext_merge_prefix.restype = i64
        lib.ext_merge_prefix.argtypes = [vp]
        _MERGE = lib
    return _MERGE


def ext_merge_available() -> bool:
    """Whether the merge can run: its library is built, or the host C++
    compiler that builds it is on PATH (the build raises with its output)."""
    return _MERGE is not None or shutil.which("c++") is not None or os.path.exists(
        cuda_build.library_path("extmerge"))


def ext_merge_async_available() -> bool:
    """The live merge comes from the same library as the serial one."""
    return ext_merge_available()


def _merge_threads(threads: int) -> int:
    if threads > 0:
        return threads
    env = os.environ.get("BFQ_EXT_THREADS")
    return int(env) if env and int(env) > 0 else (os.cpu_count() or 2)


def _merge_args(text, qtext, sa_chunks, lcp_chunks, out):
    """Contiguous inputs and the five outputs of a merge, checked."""
    text = np.ascontiguousarray(text, np.uint8)
    qtext = np.ascontiguousarray(qtext, np.uint8)
    if isinstance(sa_chunks, tuple):
        sa_all, offs = sa_chunks
        sa_dtype = np.int64 if sa_all.dtype == np.int64 else np.int32
        offs = np.ascontiguousarray(offs, np.int64)
    else:
        sa_dtype = np.int64 if any(np.asarray(c).dtype == np.int64 for c in sa_chunks) else np.int32
        sa_all = np.concatenate(sa_chunks)
        offs = np.zeros(len(sa_chunks) + 1, np.int64)
        np.cumsum([len(c) for c in sa_chunks], out=offs[1:])
    sa_all = np.ascontiguousarray(sa_all, sa_dtype)
    total = int(offs[-1])
    if lcp_chunks is None:
        lcp_all = None
    else:
        lcp_all = np.ascontiguousarray(
            lcp_chunks if isinstance(lcp_chunks, np.ndarray) else np.concatenate(lcp_chunks), np.uint8)
        if lcp_all.size != total:
            raise ValueError("lcp_chunks must align with sa_chunks")
    if out is not None:
        if any(a.size != total for a in out):
            raise ValueError("out arrays must have the merged total size")
        if out[4].dtype != sa_dtype:
            raise ValueError(f"out sa dtype {out[4].dtype} != input {sa_dtype}")
    else:
        out = tuple(np.empty(total, np.uint8) for _ in range(4)) + (np.empty(total, sa_dtype),)
    # each pointer keeps its array alive (numpy's data_as) while the merge runs
    args = [_ptr(text), _ptr(qtext), ctypes.c_int64(text.size),
            _ptr(sa_all), _ptr(lcp_all) if lcp_all is not None else None,
            _ptr(offs), ctypes.c_int32(offs.size - 1), *(_ptr(a) for a in out)]
    return args, out, total, sa_dtype == np.int64


def ext_merge(text: np.ndarray, qtext: np.ndarray, sa_chunks, lcp_chunks, out=None, *,
              threads: int = 0, ranges: int = 0):
    """K-way merge of per-chunk sorted suffix orders (csrc/extmerge.cpp).

    text/qtext: [n_pad] u8 padded layout (0 = terminator/pad); sa_chunks: a
    tuple (sa_all, offs) of the chunks' GLOBAL suffix positions, each chunk
    sorted by suffix, concatenated (int32, or int64 beyond 2^31 positions),
    plus int64 chunk offsets, or a list of the chunks.  lcp_chunks: the
    aligned u8 255-capped intra-chunk LCPs from the device sorts, which make
    the merge's loser tree compare integers and walk the text only on exact
    ties, or None (the word-wise tree).  Returns (bwt, qs, lcp_u8, pre, sa)
    in merged order, merged on `threads` host threads (0: one per core,
    BFQ_EXT_THREADS overrides) over `ranges` output ranges (0: 8 per
    thread).  out (optional): 5 preallocated arrays (bwt, qs, lcp, pre,
    sa), np.memmap for the bounded-RSS path.
    """
    lib = _merge_lib()
    args, out, total, wide = _merge_args(text, qtext, sa_chunks, lcp_chunks, out)
    fn = lib.ext_merge_mt3 if wide else lib.ext_merge_mt2
    rc = fn(*args, ctypes.c_int32(threads), ctypes.c_int32(ranges))
    if rc != total:
        raise RuntimeError(f"native ext_merge rc={rc} (expected {total})")
    return out


class ExtMergeHandle:
    """A running k-way merge whose merged PREFIX can be consumed live.

    merged_prefix() returns P such that every output position < P is final
    (BWT/QS/LCP/pre/SA all written, the boundary LCPs of the range seams
    fixed); it reads the merge's cursors with acquire loads.  wait_until(pos)
    blocks until P >= pos; join() waits for the merge and raises its error
    (a negative rc, or whatever the thread raised) in the caller's thread,
    as wait_until does once the merge has ended.  prefix_s maps each of
    PREFIX_MARKS to the seconds after the start at which the prefix first
    reached that share of the total (sampled every 5 ms).  outputs holds the
    five output arrays.
    """

    def __init__(self, lib, prog: np.ndarray, total: int, outputs, run):
        self.outputs = outputs
        self.total = total
        self.prefix_s: dict = {}
        self._lib = lib
        self._prog = prog
        self._result: dict = {}
        self._done = threading.Event()
        self.started = time.perf_counter()

        def merge():
            try:
                self._result["rc"] = rc = run()
                if rc != total:
                    self._result["error"] = RuntimeError(f"native ext_merge rc={rc} (expected {total})")
            except BaseException as e:  # surfaces in join(): never dies silently
                self._result["error"] = e
            finally:
                self._done.set()

        self._thread = threading.Thread(target=merge, daemon=True, name="ext_merge")
        self._watcher = threading.Thread(target=self._watch, daemon=True, name="ext_merge_prefix")
        self._thread.start()
        self._watcher.start()

    def _watch(self) -> None:
        pending = list(PREFIX_MARKS)
        while pending:
            done = self._done.wait(0.005)
            p = self.merged_prefix()
            t = time.perf_counter() - self.started
            while pending and p >= pending[0] * self.total:
                self.prefix_s[pending.pop(0)] = t
            if done:
                return

    def merged_prefix(self) -> int:
        return int(self._lib.ext_merge_prefix(_ptr(self._prog)))

    def finished(self, timeout: Optional[float] = None) -> bool:
        """Whether the merge thread has ended, waiting up to `timeout`
        seconds (None: until it ends); raises nothing."""
        return self._done.wait(timeout)

    def wait_until(self, pos: int, poll_s: float = 0.01) -> None:
        pos = min(pos, self.total)
        while self.merged_prefix() < pos:
            if self._done.wait(poll_s):
                self.join()  # raises on error; else the whole output is final
                return

    def join(self) -> int:
        self._thread.join()
        self._watcher.join()
        if "error" in self._result:
            raise self._result["error"]
        return self._result["rc"]


def ext_merge_async(text: np.ndarray, qtext: np.ndarray, sa_chunks, threads: int = 0,
                    lcp_chunks=None, out=None, *, ranges: int = 0,
                    step: int = PROGRESS_STEP) -> ExtMergeHandle:
    """Start ext_merge on a background thread (the ctypes call releases the
    GIL) and return a live-progress handle, so downstream stages can consume
    the merged prefix while the merge runs.  Same arguments as ext_merge;
    `step` (a power of two) is the number of emits between two progress
    publishes of a range."""
    lib = _merge_lib()
    threads = _merge_threads(threads)
    ranges = ranges if ranges > 0 else 8 * threads
    args, out, total, wide = _merge_args(text, qtext, sa_chunks, lcp_chunks, out)
    prog = np.zeros(1 + 3 * ranges, np.int64)  # the merge uses at most `ranges` ranges
    fn = lib.ext_merge_mt3p if wide else lib.ext_merge_mt2p

    def run():
        return fn(*args, ctypes.c_int32(threads), ctypes.c_int32(ranges), _ptr(prog),
                  ctypes.c_int64(step))

    return ExtMergeHandle(lib, prog, total, out, run)

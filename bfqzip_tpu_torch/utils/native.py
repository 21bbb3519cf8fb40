"""ctypes bindings for the native C++ runtime (native/libbfqnative.so).

The port's copy of the entry points of bfqzip_tpu/utils/native.py that the
port calls: FASTQ parsing, the rANS and BQZC codecs and the out-of-core
k-way merge.  It loads the shared library that `make -C native` builds in
the repository's native/ directory (at first use, if it is missing).
Parsing and the rANS coder have numpy fallbacks, so the package works
without the library; BQZC and the merge need it.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

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
        lib.rans_encode.restype = i64
        lib.rans_encode.argtypes = [vp, i64, i32, i32, vp, i64]
        lib.rans_decode.restype = i64
        lib.rans_decode.argtypes = [vp, i64, vp, i64]
        lib.cm_encode_blocked.restype = i64
        lib.cm_encode_blocked.argtypes = [vp, i64, vp, i64, i64, i32, i32]
        lib.cm_decode.restype = i64
        lib.cm_decode.argtypes = [vp, i64, vp, i64]
        for name in ("ext_merge_mt2", "ext_merge_mt3"):  # int32 / int64 positions
            fn = getattr(lib, name)
            fn.restype = i64
            fn.argtypes = [vp, vp, i64, vp, vp, vp, i32, vp, vp, vp, vp, vp, i32]
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


def cm_encode(data: bytes, pos_reset: int = -1) -> Optional[bytes]:
    """Adaptive context-model coder (native/cm_codec.cpp, magic BQZC), in
    its blocked v3 container: 16M-symbol blocks coded on a thread pool
    (BFQ_CM_THREADS overrides the count; BFQ_CM_PROFILE picks 'fast' or
    'max', default 'max').  pos_reset >= 0 enables the positional context
    model with that byte restarting the in-record position counter (pass
    ord('\\n') for line-structured streams like .fq.qs)."""
    lib = _find_lib()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    block = 16 * 1024 * 1024
    # the container carries a 4-byte length per block
    cap = len(data) + len(data) // 2 + (1 << 16) + 4 * (max(len(data) + block - 1, 1) // block) + 64
    out = np.zeros(cap, np.uint8)
    size = lib.cm_encode_blocked(_ptr(buf), len(data), _ptr(out), cap, ctypes.c_int64(0),
                                 ctypes.c_int(0), ctypes.c_int(pos_reset))
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


def ext_merge_available() -> bool:
    return _find_lib() is not None


def ext_merge(text: np.ndarray, qtext: np.ndarray, sa_chunks, lcp_chunks: np.ndarray, out=None):
    """K-way merge of per-chunk sorted suffix orders (native/extmerge.cpp).

    text/qtext: [n_pad] u8 padded layout (0 = terminator/pad); sa_chunks: a
    tuple (sa_all, offs) of the chunks' GLOBAL suffix positions, each chunk
    sorted by suffix, concatenated (int32, or int64 beyond 2^31 positions),
    plus int64 chunk offsets.  lcp_chunks: the aligned u8 255-capped
    intra-chunk LCPs from the device sorts, which make the merge's loser
    tree compare integers and walk the text only on exact ties.  Returns
    (bwt, qs, lcp_u8, pre, sa) in merged order, merged on one host thread
    per core (BFQ_EXT_THREADS overrides the count).  out (optional): 5
    preallocated arrays (bwt, qs, lcp, pre, sa), np.memmap for the
    bounded-RSS path.
    """
    lib = _find_lib()
    if lib is None:
        raise RuntimeError("native ext_merge unavailable (make -C native)")
    text = np.ascontiguousarray(text, np.uint8)
    qtext = np.ascontiguousarray(qtext, np.uint8)
    sa_all, offs = sa_chunks
    wide = sa_all.dtype == np.int64
    sa_dtype = np.int64 if wide else np.int32
    sa_all = np.ascontiguousarray(sa_all, sa_dtype)
    offs = np.ascontiguousarray(offs, np.int64)
    total = int(offs[-1])
    lcp_all = np.ascontiguousarray(lcp_chunks, np.uint8)
    if lcp_all.size != total:
        raise ValueError("lcp_chunks must align with sa_chunks")
    if out is not None:
        bwt, qs, lcp, pre, sa = out
        if any(a.size != total for a in out):
            raise ValueError("out arrays must have the merged total size")
        if sa.dtype != sa_dtype:
            raise ValueError(f"out sa dtype {sa.dtype} != input {sa_dtype}")
    else:
        bwt = np.empty(total, np.uint8)
        qs = np.empty(total, np.uint8)
        lcp = np.empty(total, np.uint8)
        pre = np.empty(total, np.uint8)
        sa = np.empty(total, sa_dtype)
    fn = lib.ext_merge_mt3 if wide else lib.ext_merge_mt2
    rc = fn(
        _ptr(text), _ptr(qtext), ctypes.c_int64(text.size),
        _ptr(sa_all), _ptr(lcp_all), _ptr(offs), ctypes.c_int32(offs.size - 1),
        _ptr(bwt), _ptr(qs), _ptr(lcp), _ptr(pre), _ptr(sa),
        ctypes.c_int32(0),  # 0: the native side picks the thread count
    )
    if rc != total:
        raise RuntimeError(f"native ext_merge rc={rc} (expected {total})")
    return bwt, qs, lcp, pre, sa

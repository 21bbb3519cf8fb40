"""Interleaved rANS entropy coder ("BQZR" containers) without jax.

Port of bfqzip_tpu/ops/rans.py; the containers are that module's byte for
byte (see its docstring for the design: 32-bit states, 16-bit
renormalisation, 12-bit frequencies, striped lanes, static context tables
from models/context.py).  The coder runs on the host: the native
C++ codec (utils/native.py, built by `make -C native` at first use)
when it is built, else the numpy loops below, which step through the chunk
positions vectorised across lanes with np.uint32 arithmetic (wrap-around
included) in place of the JAX package's lax.scan.
"""

from __future__ import annotations

import struct
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from bfqzip_tpu_torch.models.context import ContextSpec, Order0Spec, Order1Spec, Order2Spec, spec_by_id
from bfqzip_tpu_torch.utils import native
from bfqzip_tpu_torch.utils.profiling import current_span, span

PRECISION = 12
M = 1 << PRECISION
RANS_L = 1 << 16  # lower bound of the state interval
MAGIC = b"BQZR"
DEFAULT_LANES = 1024


def native_available() -> bool:
    """Whether the native rANS and BQZC codecs are built and loaded."""
    return native.available() and native.cm_available()


def _as_u8(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray)):
        return np.frombuffer(data, np.uint8)
    return np.asarray(data, np.uint8)


def choose_spec(data: np.ndarray) -> ContextSpec:
    """Pick a context order by alphabet size (table size stays bounded)."""
    k = np.unique(data).size
    if k <= 8:
        return Order2Spec
    if k <= 128:
        return Order1Spec
    return Order1Spec if k <= 256 else Order0Spec


def quantize_freqs(counts: np.ndarray) -> np.ndarray:
    """Scale per-context counts to sum M, every present symbol >= 1."""
    return _quantize(counts)[0]


def _quantize(counts: np.ndarray):
    """(quantize_freqs's table, whether a context needed the repair below)."""
    c, k = counts.shape
    total = counts.sum(axis=1, keepdims=True)
    empty = total[:, 0] == 0
    freq = np.floor(counts * (M / np.maximum(total, 1))).astype(np.int64)
    freq[(counts > 0) & (freq == 0)] = 1
    # fix drift on the most frequent symbol of each context
    drift = M - freq.sum(axis=1)
    top = np.argmax(freq, axis=1)
    freq[np.arange(c), top] += drift
    # Repair: where many rare symbols were raised to 1, a context can owe
    # more than its most frequent symbol holds (only past 64 symbols: the
    # top holds at least floor(M/k) and at most k - 1 were raised).  There the
    # debt is taken a unit at a time from the largest frequency, none
    # falling below 1 (M exceeds k, so it always can be).
    short = np.flatnonzero(freq[np.arange(c), top] < 1)
    for r in short:
        row = freq[r]
        row[top[r]] -= drift[r]
        for _ in range(-int(drift[r])):
            row[np.argmax(row)] -= 1
    # unseen contexts: uniform (never exercised, but tables must be valid)
    if empty.any():
        base = M // k
        u = np.full(k, base, np.int64)
        u[0] += M - base * k
        freq[empty] = u
    if not (freq.sum(axis=1) == M).all():
        raise ValueError("quantised frequencies do not sum to M")
    return freq.astype(np.uint16), short.size > 0


def _prepare(data: np.ndarray, spec: ContextSpec, lanes: int):
    n = data.size
    uniq = np.unique(data) if n else np.array([0], np.uint8)
    k = uniq.size
    dense_map = np.zeros(256, np.uint8)
    dense_map[uniq] = np.arange(k, dtype=np.uint8)

    chunk = max((n + lanes - 1) // lanes, 1)
    padded = np.zeros(lanes * chunk, np.uint8)
    padded[:n] = data
    if n:
        padded[n:] = data[-1]  # repeat last symbol; excluded via n on decode
    rows = dense_map[padded].reshape(lanes, chunk)
    ctx = spec.contexts(rows, k)

    c = spec.num_contexts(k)
    counts = np.bincount((ctx * k + rows).reshape(-1), minlength=c * k).reshape(c, k)
    freq, repaired = _quantize(counts)
    cum = np.zeros((freq.shape[0], k + 1), np.uint32)
    cum[:, 1:] = np.cumsum(freq, axis=1, dtype=np.uint32)
    return uniq, k, chunk, rows, ctx, freq, cum, repaired


def _encode_scan(rows, ctx, freq, cum, lanes, chunk):
    """Reverse pass over chunk positions; returns final states + emissions
    ([chunk, lanes], step 0 = position chunk-1)."""
    freq32 = freq.astype(np.uint32)
    rows_t = np.ascontiguousarray(rows.T, np.intp)  # [chunk, lanes]
    ctx_t = np.ascontiguousarray(ctx.T, np.intp)
    state = np.full(lanes, RANS_L, np.uint32)
    emits = np.empty((chunk, lanes), np.uint16)
    needs = np.empty((chunk, lanes), bool)
    for step in range(chunk):
        t = chunk - 1 - step
        s, c = rows_t[t], ctx_t[t]
        f = freq32[c, s]
        # shift-compare form: f << (32-PRECISION) overflows u32 when f == M
        need = (state >> np.uint32(32 - PRECISION)) >= f
        emits[step] = state & np.uint32(0xFFFF)
        needs[step] = need
        x = np.where(need, state >> np.uint32(16), state)
        state = ((x // f) << np.uint32(PRECISION)) + (x % f) + cum[c, s]
    return state, emits, needs


def _auto_lanes(n: int, lanes: int) -> int:
    """Shrink the lane count for small inputs (4 bytes of header per lane)."""
    while lanes > 8 and lanes * 512 > max(n, 1):
        lanes //= 2
    return lanes


def encode(data, spec: ContextSpec | None = None, lanes: int = DEFAULT_LANES) -> bytes:
    data = _as_u8(data)
    spec = spec or choose_spec(data)
    lanes = _auto_lanes(data.size, lanes)
    uniq, k, chunk, rows, ctx, freq, cum, _ = _prepare(data, spec, lanes)

    final, emits, needs = _encode_scan(rows, ctx, freq, cum, lanes, chunk)
    # emission order: steps t=chunk-1..0, lanes high->low within a step, so
    # the reversed payload reads (t=0, lane 0..L-1), (t=1, ...) — the decode
    # consumption order.
    flat_vals = emits[:, ::-1].reshape(-1)
    flat_mask = needs[:, ::-1].reshape(-1)
    payload = flat_vals[flat_mask][::-1].astype("<u2")

    header = b"".join(
        [
            MAGIC,
            struct.pack("<BBBx", 1, spec.spec_id, k - 1),
            struct.pack("<QII", data.size, lanes, payload.size),
            uniq.tobytes(),
            freq.astype("<u2").tobytes(),
            final.astype("<u4").tobytes(),
        ]
    )
    return header + payload.tobytes()


def encode_best(data, lanes: int = DEFAULT_LANES) -> bytes:
    """Encode under each affordable context order and keep the smallest blob
    (span `codec.rans`).  Uses the native C++ codec when built; the
    containers are identical, save where a context's table needs
    _quantize's repair, which the native coder lacks: past 64 symbols each
    order's table is checked first, and one that needs it is coded here."""
    with span("codec.rans"):
        data = _as_u8(data)
        k = np.count_nonzero(np.bincount(data)) if data.size else 1  # distinct symbols
        specs = [Order0Spec, Order1Spec]
        if k <= 16:
            specs.append(Order2Spec)

        if native.available():
            raw, native_lanes = data.tobytes(), _auto_lanes(data.size, lanes)
            blobs = [encode(data, sp, lanes) if k > 64 and _prepare(data, sp, native_lanes)[-1]
                     else native.rans_encode(raw, sp.order, native_lanes) for sp in specs]
            return min(blobs, key=len)
        blobs = [encode(data, sp, lanes) for sp in specs]
        return min(blobs, key=len)


def encode_blob_best(data, lanes: int = DEFAULT_LANES, pos_reset: int = -1) -> bytes:
    """Best available entropy container for a byte stream: the adaptive
    context-model coder (BQZC, native/cm_codec.cpp) when the native library
    is built, vs the static-table rANS (BQZR); smallest wins.  pos_reset
    enables BQZC's positional contexts for line-structured streams.  Decode
    with decode_blob, which dispatches on the magic.

    The BQZC encode (span `codec.cm`, a child of the caller's open span)
    runs on a thread of its own beside the BQZR orders: both native coders
    release the GIL, so a stream costs the longer of the two, not their sum."""
    if not native.cm_available():
        return encode_best(data, lanes)
    raw = data if isinstance(data, (bytes, bytearray)) else np.asarray(data, np.uint8).tobytes()
    with ThreadPoolExecutor(max_workers=1) as pool:
        cm = pool.submit(_cm_encode, raw, pos_reset, current_span())
        blobs = [encode_best(data, lanes), cm.result()]
    return min(blobs, key=len)


def _cm_encode(raw: bytes, pos_reset: int, parent) -> bytes:
    with span("codec.cm", parent=parent):
        return native.cm_encode(raw, pos_reset=pos_reset)


def container_name(blob: bytes) -> str:
    """The container an entropy blob is: "BQZR/o<order>" for the static
    rANS coder at that context order, else its magic ("BQZC")."""
    if blob[:4] == MAGIC:
        return f"BQZR/o{spec_by_id(blob[5]).order}"
    return blob[:4].decode("ascii")


def decode_blob(blob: bytes) -> np.ndarray:
    """Decode any bfqzip entropy container (BQZR rANS or BQZC context-model)."""
    if blob[:4] == b"BQZC":
        out = native.cm_decode(blob)
        if out is None:
            raise RuntimeError("BQZC container needs the native library (make -C native)")
        return out
    return decode(blob)


def decode(blob: bytes) -> np.ndarray:
    if blob[:4] != MAGIC:
        raise ValueError("not a bfqzip rANS container")
    ver, spec_id, km1 = struct.unpack_from("<BBB", blob, 4)
    if ver != 1:
        raise ValueError(f"unsupported container version {ver}")
    k = km1 + 1
    n, lanes, plen = struct.unpack_from("<QII", blob, 8)
    off = 24
    uniq = np.frombuffer(blob, np.uint8, k, off); off += k
    spec = spec_by_id(spec_id)
    c = spec.num_contexts(k)
    freq = np.frombuffer(blob, "<u2", c * k, off).reshape(c, k).astype(np.uint32); off += 2 * c * k
    states = np.frombuffer(blob, "<u4", lanes, off).astype(np.uint32); off += 4 * lanes
    payload = np.frombuffer(blob, "<u2", plen, off).astype(np.uint32)

    cum = np.zeros((c, k + 1), np.uint32)
    cum[:, 1:] = np.cumsum(freq, axis=1, dtype=np.uint32)
    # slot -> symbol lookup per context: symbol s occupies freq[c, s] slots
    slot_sym = np.repeat(
        np.tile(np.arange(k, dtype=np.uint8), c), freq.reshape(-1).astype(np.int64)
    ).reshape(c, M)

    chunk = max((n + lanes - 1) // lanes, 1)
    out = _decode_scan(states, payload, freq, cum, slot_sym, spec, k, lanes, chunk)
    flat = out.T.reshape(-1)[:n]
    return uniq[flat]


def _decode_scan(states, payload, freq, cum, slot_sym, spec, k, lanes, chunk):
    """Forward pass over chunk positions; returns the symbols [chunk, lanes]."""
    pay = np.concatenate([payload, np.zeros(lanes, np.uint32)])
    kpow = [k**o for o in range(spec.order)]
    x = states.copy()
    offset = 0
    # hist[:, o] = symbol at distance o+1 in the lane
    hist = np.zeros((lanes, max(spec.order, 1)), np.intp)
    syms = np.empty((chunk, lanes), np.uint8)
    for step in range(chunk):
        ctxv = np.zeros(lanes, np.intp)
        for o in range(spec.order):
            ctxv += hist[:, o] * kpow[o]
        slot = x & np.uint32(M - 1)
        s = slot_sym[ctxv, slot].astype(np.intp)
        x = freq[ctxv, s] * (x >> np.uint32(PRECISION)) + slot - cum[ctxv, s]
        need = x < RANS_L
        within = np.cumsum(need) - need
        x = np.where(need, (x << np.uint32(16)) | pay[offset + within], x)
        offset += int(need.sum())
        if spec.order:
            hist[:, 1:] = hist[:, :-1]
            hist[:, 0] = s
        syms[step] = s
    return syms

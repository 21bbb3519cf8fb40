"""The port's out-of-core scan toolbox and smooth_fastq_external against
bfqzip_tpu.external on the same inputs, on the CPU.

SeqChunkOps is driven segment by segment with its carries, as the
streaming smoother drives it: int32 against the JAX SeqChunkOps and the
whole-array scan, int64 (coordinates beyond 2^31) against a numpy loop over
the whole array.  Then smooth_fastq_external's outputs and stats are
byte-equal to the JAX function's for the JAX test suite's five
parametrisations.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bfqzip_tpu import SmoothConfig
from bfqzip_tpu.external import SeqChunkOps as JaxSeqChunkOps
from bfqzip_tpu.external import smooth_fastq_external as jax_external
from bfqzip_tpu.io.fastq import read_fastq
from bfqzip_tpu_torch.utils import native
from bfqzip_tpu_torch.external import SeqChunkOps, smooth_fastq_external
from bfqzip_tpu_torch.ops.scan import LocalScanOps

from conftest import golden_path
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

L, SEG, HALO = 20_000, 3_001, 9  # six segment boundaries
BIG = 1 << 33  # a global base past int32

_RNG = np.random.default_rng(31)
_FLAG = _RNG.random(L) < 0.002
_FLAG[:40] = False  # the first segment runs from init


def _window(x, lo, fill):
    """x[..., lo : lo + SEG + HALO], padded past the end."""
    w = x[..., lo : lo + SEG + HALO]
    pad = SEG + HALO - w.shape[-1]
    if pad:
        w = np.concatenate([w, np.full(w.shape[:-1] + (pad,), fill, w.dtype)], axis=-1)
    return w


def _segments(make_ops, to_array, call, x, fill):
    """Each segment's [SEG] output, stitched; call(ops, window, flag window)."""
    outs, carries = [], None
    for lo in range(0, L, SEG):
        ops = make_ops(lo, carries)
        out = call(ops, to_array(_window(x, lo, fill)), to_array(_window(_FLAG, lo, False)))
        outs.append(np.asarray(out)[..., :SEG])
        carries = ops.carries_out
    return np.concatenate(outs, axis=-1)[..., :L]


def _torch_segments(call, x, fill, base=0, dtype=torch.int32):
    return _segments(lambda lo, c: SeqChunkOps(torch.tensor(base + lo, dtype=dtype), SEG, c),
                     torch.as_tensor, call, x, fill)


_TORCH_CALLS = {
    "cummax": lambda o, v, f: o.cummax(v),
    "shift_prev": lambda o, v, f: o.shift_prev(v, 0),
    "seg_cumsum": lambda o, v, f: o.seg_cumsum(v, f),
    "seg_cummax": lambda o, v, f: o.seg_cummax(v, f),
    "seg_cumor": lambda o, v, f: o.seg_cumor(v, f),
    "seg_scan_f64": lambda o, v, f: o.seg_scan(v, f, "add", 0.0),
}
_JAX_CALLS = dict(_TORCH_CALLS, seg_scan_f64=lambda o, v, f: o.seg_scan(v, f, jnp.add, 0.0))


def _input(method):
    if method == "cummax":
        return np.where(_RNG.random(L) < 0.001, np.arange(L), -1).astype(np.int32), -1
    if method == "seg_scan_f64":
        return _RNG.random(L), 0.0
    shape = (5, L) if method == "seg_cumsum" else (L,)
    return _RNG.integers(0, 1 << 20, shape, dtype=np.int32), 0


@pytest.mark.parametrize("method", list(_TORCH_CALLS))
def test_seq_chunk_ops_match_jax_segment_by_segment(method):
    x, fill = _input(method)
    got = _torch_segments(_TORCH_CALLS[method], x, fill)
    want = _segments(lambda lo, c: JaxSeqChunkOps(lo, SEG, c), jnp.asarray, _JAX_CALLS[method], x, fill)
    # and the segments stitch into the whole-array scan
    whole = _TORCH_CALLS[method](LocalScanOps(), torch.as_tensor(x), torch.as_tensor(_FLAG)).numpy()
    if x.dtype == np.float64:  # the plain scan and XLA sum in different orders
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
        np.testing.assert_allclose(got, whole, rtol=1e-12, atol=0)
    else:
        assert got.dtype == want.dtype == whole.dtype
        assert np.array_equal(got, want)
        assert np.array_equal(got, whole)


def test_seq_chunk_ops_iota_sum_and_no_reverse_broadcast():
    ops = SeqChunkOps(torch.tensor(3 * SEG, dtype=torch.int32), SEG, None)
    jops = JaxSeqChunkOps(3 * SEG, SEG, None)
    assert np.array_equal(ops.iota(SEG + HALO, "cpu").numpy(), np.asarray(jops.iota(SEG + HALO)))
    x = np.arange(SEG + HALO, dtype=np.int32)
    assert int(ops.sum(torch.as_tensor(x))) == int(jops.sum(jnp.asarray(x)))
    with pytest.raises(NotImplementedError):
        ops.next_marked(torch.as_tensor(x), torch.as_tensor(x > 0))


def _np_seg_scan(x, flag, combine, init):
    """Sequential reference: out[i] = x[i] at a flag, else combine(out[i-1], x[i])."""
    out = np.empty_like(x)
    run = np.full(x.shape[:-1], init, x.dtype)
    for i in range(x.shape[-1]):
        run = x[..., i].copy() if flag[i] else combine(run, x[..., i])
        out[..., i] = run
    return out


@pytest.mark.parametrize("method", ["cummax", "seg_cumsum", "seg_cummax", "shift_prev", "iota"])
def test_seq_chunk_ops_int64_carries_match_numpy(method):
    """Coordinates beyond 2^31 (the out-of-core path past ~21M reads of 101
    bp): int64 values and carries cross every segment boundary intact."""
    rng = np.random.default_rng(37)
    if method == "cummax":
        x = np.where(rng.random(L) < 0.001, BIG + np.arange(L), -1).astype(np.int64)
        want, fill = np.maximum.accumulate(x), -1
    elif method == "shift_prev":
        x = BIG + rng.integers(0, 1 << 20, L)
        want, fill = np.concatenate([[0], x[:-1]]), 0
    elif method == "iota":
        x = np.zeros(L, np.int64)
        want, fill = BIG + np.arange(L, dtype=np.int64), 0
    else:
        shape = (5, L) if method == "seg_cumsum" else (L,)
        x = rng.integers(0, 1 << 40, shape, dtype=np.int64)
        combine = np.add if method == "seg_cumsum" else np.maximum
        want, fill = _np_seg_scan(x, _FLAG, combine, 0), 0
    call = (lambda o, v, f: o.iota(v.shape[0], "cpu")) if method == "iota" else _TORCH_CALLS[method]
    got = _torch_segments(call, x, fill, base=BIG, dtype=torch.int64)
    assert got.dtype == np.int64
    assert np.array_equal(got, want)


needs_native = pytest.mark.skipif(not native.ext_merge_available(), reason="native library not built")


@needs_native
@pytest.mark.parametrize(
    "cfg,seg,rpc",
    [
        (SmoothConfig(), None, None),  # single segment / single chunk
        (SmoothConfig(), 997, 17),  # many tiny segments + chunks
        (SmoothConfig(mode=0), 1024, 33),
        (SmoothConfig(mode=1), 1500, 29),
        (SmoothConfig(mode=3, binning=True), 2048, 40),
    ],
)
def test_external_matches_jax_external_example(monkeypatch, cfg, seg, rpc):
    monkeypatch.setenv("BFQ_EXT_OVERLAP", "0")  # the JAX route the port takes
    batch = read_fastq(golden_path("example.in.fastq"))
    rep = {}
    got, gstats = smooth_fastq_external(batch, cfg, device="cpu", _seg_len=seg,
                                        _reads_per_chunk=rpc, report=rep)
    if seg is None:
        # one chunk and one segment by default; the JAX function pads its
        # default segment to millions of positions, so it is given the same
        # single chunk and segment explicitly
        assert rep["n_chunks"] == rep["n_segments"] == 1
        seg, rpc = 1 << 16, batch.num_reads
    want, wstats = jax_external(batch, cfg, _seg_len=seg, _reads_per_chunk=rpc)
    assert np.array_equal(got.lengths, want.lengths)
    assert np.array_equal(got.seqs, np.asarray(want.seqs))
    assert np.array_equal(got.quals, np.asarray(want.quals))
    assert gstats == wstats and gstats["num_clust"] > 0


class _CountingScans(LocalScanOps):
    def __init__(self):
        self.calls = 0

    def _scan(self, *args, **kwargs):
        self.calls += 1
        return super()._scan(*args, **kwargs)


def _tensors(obj):
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [t for o in obj for t in _tensors(o)]
    if isinstance(obj, dict):
        return [t for k in sorted(obj) for t in _tensors(obj[k])]
    return []


@needs_native
def test_segment_rerun_with_given_scans_sends_every_scan_through_them(monkeypatch):
    """A recorded middle segment rerun through _part1_segment(scans=...)
    gives the same outputs, carries included, and sends every scan (the
    carried ones and the decision-word broadcast) through `scans`: the
    card's check reruns a segment of the out-of-core path with the plain
    scans, and a scan that bypassed them would go unchecked."""
    from bfqzip_tpu_torch import external
    from bfqzip_tpu_torch.ops.scan import LOCAL_OPS

    part1, calls = external._part1_segment, []

    def recording(*args, **kwargs):
        out = part1(*args, **kwargs)
        calls.append((args, out))
        return out

    monkeypatch.setattr(external, "_part1_segment", recording)
    batch = read_fastq(golden_path("example.in.fastq"))
    smooth_fastq_external(batch, SmoothConfig(), device="cpu", _seg_len=997, _reads_per_chunk=17)
    assert len(calls) > 5
    args, want = calls[len(calls) // 2]
    assert args[5] is not None  # the segment starts from carries

    def bypass(*args, **kwargs):
        raise AssertionError("a scan bypassed `scans`")

    monkeypatch.setattr(LOCAL_OPS, "_scan", bypass)
    scans = _CountingScans()
    got = part1(*args, scans=scans)
    assert scans.calls >= 5
    assert len(_tensors(got)) == len(_tensors(want)) > 10
    for g, w in zip(_tensors(got), _tensors(want)):
        assert g.dtype == w.dtype and torch.equal(g, w)

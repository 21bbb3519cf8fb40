"""The port's plain segmented scan and LocalScanOps against the JAX package.

The same numpy inputs go through bfqzip_tpu's Pallas kernel (interpret mode,
as tests/test_pallas_scan.py runs it), its XLA scan, next_marked and
jax.lax.cummax, and through bfqzip_tpu_torch on CPU tensors.  Integer results
must be exactly equal, float64 sums within 1e-12 relative error (the two
sum in different orders).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bfqzip_tpu.ops import scan as jscan
from bfqzip_tpu_torch.ops import scan as tscan
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

N = 70_000  # crosses the Pallas kernel's 64K-position blocks
INT32_MIN = np.iinfo(np.int32).min
_JAX_COMBINE = {"add": jnp.add, "max": jnp.maximum, "or": jnp.bitwise_or,
                "keepleft": lambda a, b: a}
_INIT = {"add": 0, "max": INT32_MIN, "or": 0, "keepleft": 0}


@pytest.fixture(scope="module")
def pallas_interp():
    import bfqzip_tpu.ops.pallas_scan as ps

    old = ps._INTERPRET
    ps._INTERPRET = True
    yield ps
    ps._INTERPRET = old


def _inputs(channels, seed, flag_p=0.003):
    rng = np.random.default_rng(seed)
    shape = (N,) if channels is None else (channels, N)
    x = rng.integers(-1000, 1000, shape, dtype=np.int32)
    f = rng.random(N) < flag_p
    f[0] = False  # the first segment runs from init
    return x, f


@pytest.mark.parametrize("channels", [None, 3, 5])
@pytest.mark.parametrize("op", ["add", "max", "or", "keepleft"])
def test_plain_seg_scan_matches_pallas(pallas_interp, op, channels):
    x, f = _inputs(channels, seed=10 * len(op) + (channels or 1))
    if op == "or":
        x = np.abs(x)
    want = np.asarray(pallas_interp.seg_scan_1p(jnp.asarray(x), jnp.asarray(f), op))
    got = tscan.seg_scan(torch.as_tensor(x), torch.as_tensor(f), op, _INIT[op]).numpy()
    assert np.array_equal(got, want)
    # and the XLA segmented scan; keepleft there is last_marked, defined for
    # values masked to the flags (before the first flag it repeats x[0])
    if op == "keepleft":
        x = np.where(f, x, 0).astype(np.int32)
        got = tscan.seg_scan(torch.as_tensor(x), torch.as_tensor(f), op, 0).numpy()
    xla = np.asarray(jscan._seg_scan(jnp.asarray(x), jnp.asarray(f), _JAX_COMBINE[op], _INIT[op]))
    assert np.array_equal(got, xla)


@pytest.mark.parametrize("channels", [None, 3, 5])
def test_plain_seg_scan_float64_add(channels):
    rng = np.random.default_rng(7)
    shape = (N,) if channels is None else (channels, N)
    x = rng.random(shape)
    f = rng.random(N) < 0.003
    want = np.asarray(jscan._seg_scan(jnp.asarray(x), jnp.asarray(f), jnp.add, 0.0))
    got = tscan.seg_scan(torch.as_tensor(x), torch.as_tensor(f), "add", 0.0).numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


_TORCH_COMBINE = {"add": np.add, "max": np.maximum, "or": np.bitwise_or,
                  "keepleft": lambda a, b: np.broadcast_to(a, b.shape)}


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("channels", [None, 3])
@pytest.mark.parametrize("op", ["add", "max", "or", "keepleft"])
def test_plain_seg_scan_tensor_init_is_a_carry(op, channels, dtype):
    """A 0-d or [C] tensor init continues each channel from a carry:
    scan(x, init=carry) == where(seen, local, combine(carry, local)), local
    being the scan from the op's identity (keepleft's init is any value)."""
    rng = np.random.default_rng(40 + len(op) + (channels or 1))
    shape = (N,) if channels is None else (channels, N)
    hi = 2**40 if dtype == np.int64 else 2**20
    lo = 0 if op in ("add", "or") else -hi
    x = rng.integers(lo, hi, shape, dtype=dtype)
    f = rng.random(N) < 0.003
    f[:50] = False
    carry = rng.integers(lo, hi, () if channels is None else (channels,), dtype=dtype)
    ident = {"add": 0, "max": int(np.iinfo(dtype).min), "or": 0, "keepleft": 0}[op]
    local = tscan.seg_scan(torch.as_tensor(x), torch.as_tensor(f), op, ident).numpy()
    seen = np.cumsum(f) > 0
    c = carry if channels is None else carry[:, None]
    want = np.where(seen, local, _TORCH_COMBINE[op](c, local))
    got = tscan.seg_scan(torch.as_tensor(x), torch.as_tensor(f), op, torch.as_tensor(carry)).numpy()
    assert got.dtype == dtype
    assert np.array_equal(got, want)


def test_flagless_cummax_with_minus_one():
    rng = np.random.default_rng(3)
    x = np.where(rng.random(N) < 0.9, -1, np.arange(N)).astype(np.int32)
    x[:100] = -1
    want = np.asarray(jax.lax.cummax(jnp.asarray(x)))
    ops = tscan.LocalScanOps()
    got = ops.cummax(torch.as_tensor(x)).numpy()
    assert np.array_equal(got, want)
    assert got[0] == -1  # no 0 leaks in before the first value


@pytest.mark.parametrize("method", ["seg_cumsum", "seg_cummax", "seg_cumor", "next_marked",
                                    "seg_scan_max", "cummax"])
def test_local_ops_match_jax(method):
    rng = np.random.default_rng(11)
    x = rng.integers(0, 1 << 20, N, dtype=np.int32)
    x5 = rng.integers(0, 50, (5, N), dtype=np.int32)
    f = rng.random(N) < 0.01
    jops, tops = jscan.LocalScanOps(), tscan.LocalScanOps()
    jx, jf, tx, tf = jnp.asarray(x), jnp.asarray(f), torch.as_tensor(x), torch.as_tensor(f)
    if method == "seg_cumsum":
        want = jops.seg_cumsum(jnp.asarray(x5), jf)
        got = tops.seg_cumsum(torch.as_tensor(x5), tf)
    elif method == "seg_scan_max":
        want = jops.seg_scan(jx, jf, jnp.maximum, 0)
        got = tops.seg_scan(tx, tf, "max", 0)
    elif method == "cummax":
        want = jops.cummax(jx)
        got = tops.cummax(tx)
    elif method == "next_marked":
        xm = np.where(f, x, 0).astype(np.int32)
        want = jops.next_marked(jnp.asarray(xm), jf, init=0)
        got = tops.next_marked(torch.as_tensor(xm), tf, init=0)
    else:
        want = getattr(jops, method)(jx, jf)
        got = getattr(tops, method)(tx, tf)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_local_ops_shifts_iota_sum():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 100, 1000, dtype=np.int32)
    jops, tops = jscan.LocalScanOps(), tscan.LocalScanOps()
    jx, tx = jnp.asarray(x), torch.as_tensor(x)
    assert np.array_equal(tops.iota(1000, "cpu").numpy(), np.asarray(jops.iota(1000)))
    assert np.array_equal(tops.shift_prev(tx, 7).numpy(), np.asarray(jops.shift_prev(jx, 7)))
    assert np.array_equal(tops.shift_next(tx, 7).numpy(), np.asarray(jops.shift_next(jx, 7)))
    for k in (1, 3):
        assert np.array_equal(tops.shift_next_k(tx, k, 0).numpy(),
                              np.asarray(jops.shift_next_k(jx, k, 0)))
    assert int(tops.sum(tx)) == int(jops.sum(jx))


def test_kernel_init_becomes_one_value_per_channel():
    """The kernel reads init as a contiguous [C] array of x's dtype: a number
    fills it, a 0-d or [C] carry is broadcast; other shapes are refused."""
    from bfqzip_tpu_torch.ops.cuda_scan import _channel_init

    got = _channel_init(-5, torch.int64, 3, "cpu")
    assert got.dtype == torch.int64 and got.tolist() == [-5, -5, -5]
    got = _channel_init(torch.tensor(7, dtype=torch.int32), torch.int64, 4, "cpu")
    assert got.is_contiguous() and got.dtype == torch.int64 and got.tolist() == [7] * 4
    carry = torch.arange(5, dtype=torch.int32)
    assert torch.equal(_channel_init(carry, torch.int32, 5, "cpu"), carry)
    with pytest.raises(ValueError, match="0-d or"):
        _channel_init(carry, torch.int32, 3, "cpu")
    with pytest.raises(ValueError, match="lies on"):
        _channel_init(torch.zeros(3, device="meta"), torch.int32, 3, "cpu")

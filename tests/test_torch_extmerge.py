"""The port's k-way merge (csrc/extmerge.cpp through utils/native) on the CPU.

The chunk orders are built as the JAX package's tests build them (3,200
reads of 30-48 bp, 400 distinct reads eight times over, in 8 chunks sorted
by bfqzip_tpu's build_ebwt).  The port's serial and live merges are
byte-equal, in all five outputs, to bfqzip_tpu.utils.native.ext_merge at 1,
2 and 8 threads, with one range per thread and with 8, over int32 and int64
positions, with the chunk LCPs given and absent.  A consumer that polls the
live merge's prefix finds every position below it final; the handshake at
the range seams never waits, at one thread either; bad input and a failed
build raise.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest

from bfqzip_tpu.io.fastq import ReadBatch
from bfqzip_tpu.ops.suffix import build_ebwt
from bfqzip_tpu.utils import native as jax_native
from bfqzip_tpu_torch.utils import cuda_build, native

from conftest import golden_path
from tests_util import tiny_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_S = 120  # a merge of these orders takes milliseconds; this bounds a hang


@pytest.fixture(scope="module")
def orders():
    """(text, qtext, sa_chunks, lcp_chunks) of 3,200 reads in 8 chunks."""
    rng = np.random.default_rng(17)
    base = tiny_batch(rng, n_reads=400, min_len=30, max_len=48, n_frac=0.02)
    batch = ReadBatch(seqs=np.concatenate([base.seqs] * 8), quals=np.concatenate([base.quals] * 8),
                      lengths=np.concatenate([base.lengths] * 8), headers=None)
    n, w = batch.seqs.shape
    wp = w + 1
    k = np.arange(wp)[None, :]
    text = np.where(k < batch.lengths[:, None],
                    np.pad(batch.seqs, ((0, 0), (0, 1))).astype(np.uint8) + 1, 0).reshape(-1)
    qtext = np.pad(batch.quals, ((0, 0), (0, 1))).reshape(-1)
    bounds = np.linspace(0, n, 9).astype(int)
    sa_chunks, lcp_chunks = [], []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        dev = build_ebwt(jnp.asarray(batch.seqs[lo:hi]), jnp.asarray(batch.quals[lo:hi]),
                         jnp.asarray(batch.lengths[lo:hi]))
        sa_chunks.append((np.asarray(dev.sa)[: int(dev.n)] + lo * wp).astype(np.int32))
        lcp_chunks.append(np.minimum(np.asarray(dev.lcp), 255).astype(np.uint8)[: int(dev.n)])
    return text, qtext, sa_chunks, lcp_chunks


_WANT = {}


def _want(orders, wide: bool, lcp: bool):
    """The JAX package's native merge of the same orders, on one thread."""
    key = (wide, lcp)
    if key not in _WANT:
        text, qtext, sa_chunks, lcp_chunks = orders
        if not jax_native.ext_merge_available():
            pytest.skip("the JAX package's native library is not built")
        chunks = [c.astype(np.int64) for c in sa_chunks] if wide else sa_chunks
        _WANT[key] = jax_native.ext_merge(text, qtext, chunks, threads=1,
                                          lcp_chunks=lcp_chunks if lcp else None)
    return _WANT[key]


def _inputs(orders, wide: bool, lcp: bool):
    text, qtext, sa_chunks, lcp_chunks = orders
    sa_all = np.concatenate(sa_chunks).astype(np.int64 if wide else np.int32)
    offs = np.concatenate([[0], np.cumsum([len(c) for c in sa_chunks])]).astype(np.int64)
    return text, qtext, (sa_all, offs), np.concatenate(lcp_chunks) if lcp else None


def _assert_outputs(got, want, what: str):
    assert len(got) == len(want) == 5
    for name, g, w in zip(("bwt", "qs", "lcp", "pre", "sa"), got, want):
        assert g.dtype == w.dtype, f"{what}: {name} dtype"
        assert np.array_equal(g, w), f"{what}: {name} differs"


_CASES = [(t, r, wide, lcp) for t in (1, 2, 8) for r in ("one_per_thread", "eight_per_thread")
          for wide in (False, True) for lcp in (True, False)]


@pytest.mark.parametrize("threads,ranges,wide,lcp", _CASES)
def test_serial_merge_matches_jax_native(orders, threads, ranges, wide, lcp):
    text, qtext, sa_chunks, lcp_all = _inputs(orders, wide, lcp)
    got = native.ext_merge(text, qtext, sa_chunks, lcp_all, threads=threads,
                           ranges=threads if ranges == "one_per_thread" else 0)
    _assert_outputs(got, _want(orders, wide, lcp), f"threads={threads} {ranges}")


def test_merge_takes_a_list_of_chunks_and_the_thread_variable(orders, monkeypatch):
    """The JAX call's list of chunks, and BFQ_EXT_THREADS read by the
    library when no thread count is given."""
    text, qtext, sa_chunks, lcp_chunks = orders
    monkeypatch.setenv("BFQ_EXT_THREADS", "3")
    got = native.ext_merge(text, qtext, sa_chunks, lcp_chunks)
    _assert_outputs(got, _want(orders, False, True), "list of chunks")


def _consume(handle, want, poll_limit: int = 1 << 20):
    """Poll the live prefix until the merge ends; each position is compared
    with the serial merge's the first time it lies below a seen prefix.
    Returns the prefixes seen."""
    seen, last = [], 0
    while not handle.finished(0) and len(seen) < poll_limit:
        p = handle.merged_prefix()
        assert last <= p <= handle.total, "the merged prefix went back"
        if p > last:
            for name, g, w in zip(("bwt", "qs", "lcp", "pre", "sa"), handle.outputs, want):
                assert np.array_equal(g[last:p], w[last:p]), f"{name}[{last}:{p}] not final"
            seen.append(p)
            last = p
    return seen


@pytest.fixture
def fast_switching():
    """Python threads (the consumer, the prefix sampler) switch often."""
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        yield
    finally:
        sys.setswitchinterval(interval)


@pytest.mark.parametrize("step", [1, 64])
@pytest.mark.parametrize("threads,ranges", [(1, 0), (2, 2), (2, 0), (8, 8), (8, 0), (32, 0)])
def test_live_prefix_is_final(orders, fast_switching, step, threads, ranges):
    """Every prefix a consumer reads while the merge runs is final, seams
    included; the prefix is monotone; the merge ends (no seam waits for a
    range no thread has taken: one thread, queued ranges) and equals the
    JAX merge.  32 threads are more than this host's cores."""
    text, qtext, sa_chunks, lcp_all = _inputs(orders, False, True)
    want = _want(orders, False, True)
    h = native.ext_merge_async(text, qtext, sa_chunks, threads, lcp_all, ranges=ranges, step=step)
    _consume(h, want)
    assert h.finished(JOIN_S), "the merge did not end"
    assert h.join() == h.total == want[0].size
    assert h.merged_prefix() == h.total
    _assert_outputs(h.outputs, want, f"live threads={threads} ranges={ranges} step={step}")


def test_live_merge_int64_without_lcps_matches_jax(orders):
    text, qtext, sa_chunks, _ = _inputs(orders, True, False)
    h = native.ext_merge_async(text, qtext, sa_chunks, 4, None, step=64)
    _consume(h, _want(orders, True, False))
    assert h.join() == h.total
    _assert_outputs(h.outputs, _want(orders, True, False), "live int64 without LCPs")


def test_wait_until_leaves_a_final_prefix_and_join_returns_the_total(orders):
    text, qtext, sa_chunks, lcp_all = _inputs(orders, False, True)
    want = _want(orders, False, True)
    h = native.ext_merge_async(text, qtext, sa_chunks, 4, lcp_all, step=1)
    h.wait_until(h.total // 2)
    p = h.merged_prefix()
    assert p >= h.total // 2
    for g, w in zip(h.outputs, want):
        assert np.array_equal(g[:p], w[:p])
    assert h.join() == h.total
    h.wait_until(h.total)  # returns at once
    times = [h.prefix_s[f] for f in native.PREFIX_MARKS]
    assert times == sorted(times) and times[0] >= 0


def test_out_arrays_are_written_in_place(orders):
    text, qtext, sa_chunks, lcp_all = _inputs(orders, False, True)
    want = _want(orders, False, True)
    out = tuple(np.zeros(want[0].size, np.uint8) for _ in range(4)) + (np.zeros(want[0].size, np.int32),)
    h = native.ext_merge_async(text, qtext, sa_chunks, 2, lcp_all, out=out)
    h.join()
    _assert_outputs(out, want, "out=")
    with pytest.raises(ValueError, match="dtype"):
        native.ext_merge(text, qtext, sa_chunks, lcp_all, out=out[:4] + (np.zeros(want[0].size),))


def test_bad_positions_raise_rc_minus_4():
    """Out-of-range suffix positions (untrusted input) fail with rc -4, in
    the serial merge and, through join and wait_until, in the live one."""
    rng = np.random.default_rng(5)
    batch = tiny_batch(rng, n_reads=20, min_len=10, max_len=14, n_frac=0.0)
    w = batch.seqs.shape[1] + 1
    text = np.pad(batch.seqs, ((0, 0), (0, 1))).reshape(-1)
    qtext = np.pad(batch.quals, ((0, 0), (0, 1))).reshape(-1)
    assert text.size == 20 * w
    for bad in (-1, text.size, text.size + 100):
        sa = (np.array([1, 2, bad], np.int32), np.array([0, 3], np.int64))
        with pytest.raises(RuntimeError, match="rc=-4"):
            native.ext_merge(text, qtext, sa, None)
        with pytest.raises(RuntimeError, match="rc=-4"):
            native.ext_merge_async(text, qtext, sa, 2).join()
        with pytest.raises(RuntimeError, match="rc=-4"):
            native.ext_merge_async(text, qtext, sa, 2).wait_until(3)


def test_progress_step_must_be_a_power_of_two(orders):
    text, qtext, sa_chunks, lcp_all = _inputs(orders, False, True)
    with pytest.raises(RuntimeError, match="rc=-6"):
        native.ext_merge_async(text, qtext, sa_chunks, 2, lcp_all, step=3).join()


def _no_codec_library():
    raise AssertionError("the merge fell back to native/libbfqnative.so")


def test_missing_compiler_raises_without_fallback(monkeypatch):
    import shutil

    monkeypatch.setattr(native, "_MERGE", None)
    monkeypatch.setattr(native, "_find_lib", _no_codec_library)
    monkeypatch.setattr(cuda_build, "_LOADED", {})
    monkeypatch.setattr(cuda_build, "library_path", lambda *a, **k: "/nonexistent/extmerge.so")
    monkeypatch.setattr(shutil, "which", lambda *a, **k: None)
    assert not native.ext_merge_available() and not native.ext_merge_async_available()
    text = np.ones(8, np.uint8)
    with pytest.raises(cuda_build.CudaBuildError, match="c\\+\\+ not found"):
        native.ext_merge(text, text, (np.zeros(1, np.int32), np.array([0, 1])), None)
    with pytest.raises(cuda_build.CudaBuildError, match="c\\+\\+ not found"):
        native.ext_merge_async(text, text, (np.zeros(1, np.int32), np.array([0, 1])), 1)


def test_failed_compile_raises_with_the_compiler_output(monkeypatch, tmp_path):
    (tmp_path / "extmerge.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(native, "_MERGE", None)
    monkeypatch.setattr(native, "_find_lib", _no_codec_library)
    monkeypatch.setattr(cuda_build, "_LOADED", {})
    monkeypatch.setattr(cuda_build, "CSRC_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    text = np.ones(8, np.uint8)
    with pytest.raises(cuda_build.CudaBuildError, match="extmerge.cpp") as err:
        native.ext_merge(text, text, (np.zeros(1, np.int32), np.array([0, 1])), None)
    assert "error" in str(err.value)
    assert not any(p.suffix == ".so" for p in (tmp_path / "build").iterdir())


def test_library_is_built_without_march_flags():
    assert not any(f.startswith("-march") for f in cuda_build.CXX_FLAGS)
    assert cuda_build.library_path("extmerge").startswith(os.path.join(REPO, "build", "bfqzip_tpu_torch"))


def test_bench_tool_on_the_cpu(capsys):
    """tools/bench_extmerge_torch.py --cpu: the port's build sorts the chunks,
    every merge variant agrees, the live merge's curve is complete."""
    import json
    import sys

    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import bench_extmerge_torch
    finally:
        sys.path.pop(0)
    bench_extmerge_torch.main([golden_path("example.in.fastq"), "--chunks", "4", "--threads", "2", "--cpu"])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["device"]["type"] == "cpu" and res["device"]["power_limit"] is None
    assert res["positions"] == 10_200 and res["all_equal"] and res["value"] > 0
    for curve in res["live"].values():
        assert set(curve["prefix_s"]) == {str(f) for f in native.PREFIX_MARKS}
        assert curve["final_prefix_checked"] >= 0  # a merge this small may end before a poll

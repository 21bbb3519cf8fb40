"""The port's copies of the JAX package's host modules hold to their originals.

bfqzip_tpu_torch imports nothing of bfqzip_tpu, so it carries its own
alphabet, config, FASTQ I/O, spill files, reorder, context specs, debug
dumps, CLI parser, FASTQ check and the variant proxy's simulator, caller and
scoring.  Each copy is held here against the original on the
same inputs: tables equal, the same defaults and validation errors, byte-equal
FASTQ on every golden input, the same permutations and parser actions.
"""

import dataclasses
import glob
import io
import os

import numpy as np
import pytest

from bfqzip_tpu import alphabet as jax_alphabet
from bfqzip_tpu import cli as jax_cli
from bfqzip_tpu import config as jax_config
from bfqzip_tpu.io import fastq as jax_fastq
from bfqzip_tpu.io import spill as jax_spill
from bfqzip_tpu.models import context as jax_context
from bfqzip_tpu.ref_golden import lcp_bitvectors as jax_lcp_bitvectors
from bfqzip_tpu.utils import checkfastq as jax_checkfastq
from bfqzip_tpu.utils import debug as jax_debug
from bfqzip_tpu.utils import native as jax_native
from bfqzip_tpu.utils import reorder as jax_reorder
from bfqzip_tpu.utils import variant_proxy as jax_variant_proxy
from bfqzip_tpu_torch import alphabet, cli, config
from bfqzip_tpu_torch.io import fastq, spill
from bfqzip_tpu_torch.models import context
from bfqzip_tpu_torch.utils import checkfastq, debug, native, reorder, variant_proxy

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
INPUTS = sorted(os.path.basename(p) for p in glob.glob(os.path.join(GOLDEN, "*.in.fastq")))


# ---- alphabet ----

@pytest.mark.parametrize("name", ["TERM", "A", "C", "G", "N", "T", "SIGMA", "TERM_CHAR",
                                  "_ENCODE", "_DECODE"])
def test_alphabet_table(name):
    np.testing.assert_array_equal(getattr(alphabet, name), getattr(jax_alphabet, name))


def test_alphabet_encode_decode_and_error():
    data = np.frombuffer(b"ACGTNacgtn#", np.uint8)
    np.testing.assert_array_equal(alphabet.encode(data), jax_alphabet.encode(data))
    codes = np.arange(6, dtype=np.uint8)
    np.testing.assert_array_equal(alphabet.decode(codes), jax_alphabet.decode(codes))
    for mod in (alphabet, jax_alphabet):
        with pytest.raises(ValueError, match="invalid base"):
            mod.encode(np.frombuffer(b"ACX", np.uint8))


# ---- config ----

@pytest.mark.parametrize("cls", ["SmoothConfig", "PipelineConfig"])
def test_config_defaults(cls):
    assert dataclasses.asdict(getattr(config, cls)()) == dataclasses.asdict(getattr(jax_config, cls)())


@pytest.mark.parametrize("cls,kwargs", [
    ("SmoothConfig", {"mode": 4}), ("SmoothConfig", {"mode": -1}), ("SmoothConfig", {"k": 0}),
    ("PipelineConfig", {"mode": 5}),
])
def test_config_validation_error(cls, kwargs):
    with pytest.raises(ValueError) as want:
        getattr(jax_config, cls)(**kwargs)
    with pytest.raises(ValueError) as got:
        getattr(config, cls)(**kwargs)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_smooth_config_mode_name(mode):
    assert config.SmoothConfig(mode=mode).mode_name == jax_config.SmoothConfig(mode=mode).mode_name


# ---- FASTQ I/O ----

@pytest.mark.parametrize("name", INPUTS)
def test_read_format_write_fastq_byte_equal(name, tmp_path):
    path = os.path.join(GOLDEN, name)
    got, want = fastq.read_fastq(path), jax_fastq.read_fastq(path)
    for field in ("seqs", "quals", "lengths"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    assert got.headers == want.headers
    assert fastq.format_fastq(got) == jax_fastq.format_fastq(want)
    assert fastq.format_fastq(got, headers=None) == jax_fastq.format_fastq(want, headers=None)
    fastq.write_fastq(str(tmp_path / "port.fq"), got)
    jax_fastq.write_fastq(str(tmp_path / "jax.fq"), want)
    assert (tmp_path / "port.fq").read_bytes() == (tmp_path / "jax.fq").read_bytes()


def _parse_outcome(parse, data):
    try:
        b = parse(data)
    except ValueError as e:
        return "ValueError", str(e)
    return b.seqs.tolist(), b.quals.tolist(), b.lengths.tolist(), b.headers


@pytest.mark.parametrize("data", [b"", b"@r\nACGT\n+\nIII\n", b"r\nACGT\n+\nIIII\n",
                                  b"@r\nACGT\n+\nIIII\n@s\nAC\n", b"@r\nACXT\n+\nIIII\n"])
def test_malformed_fastq_alike(data):
    assert _parse_outcome(fastq.parse_fastq, data) == _parse_outcome(jax_fastq.parse_fastq, data)


def test_numpy_parser_matches_with_max_len():
    data = open(os.path.join(GOLDEN, "synth_var.in.fastq"), "rb").read()
    got, want = fastq.parse_fastq(data, max_len=200), jax_fastq.parse_fastq(data, max_len=200)
    np.testing.assert_array_equal(got.seqs, want.seqs)
    np.testing.assert_array_equal(got.quals, want.quals)
    np.testing.assert_array_equal(got.lengths, want.lengths)


# ---- spill files ----

def test_spill_round_trip(tmp_path):
    rng = np.random.default_rng(0)
    data = rng.integers(0, 2**31, 100_000, dtype=np.int64)
    sp = spill.Spill(dir=str(tmp_path))
    arr = sp.alloc("x", data.shape, np.int64)
    arr[:] = data
    spill.Spill.evict(arr, 8 * 1000, 8 * 50_000)
    sp.evict_all()
    with sp.watcher("x", interval=0.01):
        np.testing.assert_array_equal(np.asarray(arr), data)
    spill.Spill.evict(data)  # not a memmap: a no-op
    sp.drop("x")
    assert not os.path.exists(os.path.join(sp.dir, "x"))
    sp.close()
    assert not os.path.exists(sp.dir)


def test_read_fastq_spill_matches_jax(tmp_path):
    if not (native.available() and jax_native.available()):
        pytest.skip("native library not built")
    path = os.path.join(GOLDEN, "synth_var.in.fastq")
    sp, jsp = spill.Spill(dir=str(tmp_path)), jax_spill.Spill(dir=str(tmp_path))
    try:
        got = spill.read_fastq_spill(path, sp, with_headers=True, slab_bytes=4096)
        want = jax_spill.read_fastq_spill(path, jsp, with_headers=True, slab_bytes=4096)
        assert isinstance(got.seqs, np.memmap)
        np.testing.assert_array_equal(got.seqs, want.seqs)
        np.testing.assert_array_equal(got.quals, want.quals)
        np.testing.assert_array_equal(got.lengths, want.lengths)
        assert got.headers == want.headers
    finally:
        sp.close()
        jsp.close()


# ---- native bindings: BQZC encode and the FASTQ formatter ----

def _needs_native():
    if not (native.available() and jax_native.available()):
        pytest.skip("native library not built")


def _matchy_bytes(n=600_000, seed=0):
    """tests/test_native.py's repeat-rich stream."""
    rng = np.random.default_rng(seed)
    frag = rng.integers(65, 69, 1000, dtype=np.uint8)
    parts = [frag[rng.integers(0, 900):][: rng.integers(50, 100)] for _ in range(n // 60)]
    return bytes(np.concatenate(parts)[:n])


def _qs_stream():
    """The quality lines of a golden FASTQ, newline-ended: a QS-like stream."""
    with open(os.path.join(GOLDEN, "synth_var.in.fastq"), "rb") as f:
        return b"\n".join(f.read().split(b"\n")[3::4]) + b"\n"


def _one_block():
    data = _matchy_bytes()
    return data, dict(block_size=len(data) + 1)


# case -> (stream, cm_encode keywords)
CM_CASES = {
    "blocks_100k_threads_2": lambda: (_matchy_bytes(), dict(block_size=100_000, threads=2)),
    "one_block": _one_block,
    "threads_2": lambda: (_matchy_bytes(200_000, seed=1), dict(threads=2)),
    "profile_fast": lambda: (_matchy_bytes(200_000), dict(threads=1, profile="fast")),
    "profile_max": lambda: (_matchy_bytes(200_000), dict(threads=1, profile="max")),
    "qs_pos_reset": lambda: (_qs_stream(), dict(pos_reset=ord("\n"))),
}


@pytest.mark.parametrize("case", list(CM_CASES))
def test_cm_encode_matches_jax(case):
    _needs_native()
    data, kwargs = CM_CASES[case]()
    before = os.environ.get("BFQ_CM_PROFILE")
    blob = native.cm_encode(data, **kwargs)
    assert os.environ.get("BFQ_CM_PROFILE") == before  # the profile is set for the call only
    assert blob == jax_native.cm_encode(data, **kwargs)
    assert bytes(native.cm_decode(blob)) == data


def test_cm_encode_profile_restores_the_environment(monkeypatch):
    _needs_native()
    monkeypatch.setenv("BFQ_CM_PROFILE", "max")
    data = _matchy_bytes(50_000)
    fast = native.cm_encode(data, threads=1, profile="fast")
    assert os.environ["BFQ_CM_PROFILE"] == "max"
    assert fast[6] & 2  # the container's flags mark the fast profile
    assert fast != native.cm_encode(data, threads=1)


def test_cm_encode_rejects_an_unknown_profile_alike():
    _needs_native()
    for mod in (native, jax_native):
        with pytest.raises(ValueError, match="profile"):
            mod.cm_encode(b"ACGT" * 100, profile="bad")


@pytest.mark.parametrize("headers", [True, False])
@pytest.mark.parametrize("name", ["example.in.fastq", "synth_var.in.fastq"])
def test_fastq_format_matches_jax_and_format_fastq(name, headers):
    _needs_native()
    with open(os.path.join(GOLDEN, name), "rb") as f:
        data = f.read()
    seqs, quals, lengths, hoff, hlen = native.fastq_parse(data, alphabet._ENCODE)
    hdr = (data, hoff, hlen) if headers else ()
    got = native.fastq_format(seqs, quals, lengths, alphabet._DECODE, *hdr)
    assert got == jax_native.fastq_format(seqs, quals, lengths, jax_alphabet._DECODE, *hdr)
    batch = fastq.read_fastq(os.path.join(GOLDEN, name))
    assert got == (fastq.format_fastq(batch) if headers else fastq.format_fastq(batch, headers=None))
    if headers:
        assert got == data


# ---- reorder ----

@pytest.mark.parametrize("mode", [1, 2])
@pytest.mark.parametrize("name", ["example.in.fastq", "synth_var.in.fastq"])
def test_reorder_batch(mode, name):
    batch = fastq.read_fastq(os.path.join(GOLDEN, name))
    mate = fastq.read_fastq(os.path.join(GOLDEN, name))
    got, got_mate = reorder.reorder_batch(batch, mode, mate=mate, seed=3)
    want, want_mate = jax_reorder.reorder_batch(batch, mode, mate=mate, seed=3)
    for g, w in ((got, want), (got_mate, want_mate)):
        np.testing.assert_array_equal(g.seqs, w.seqs)
        np.testing.assert_array_equal(g.lengths, w.lengths)
        assert g.headers == w.headers


def test_reorder_short_reads_and_bad_mode():
    rng = np.random.default_rng(1)
    batch = fastq.ReadBatch(seqs=rng.integers(1, 6, (50, 8), dtype=np.uint8),
                            quals=np.full((50, 8), 40, np.uint8),
                            lengths=np.full(50, 8, np.int32))
    np.testing.assert_array_equal(reorder.reorder_permutation(batch, 2),
                                  jax_reorder.reorder_permutation(batch, 2))
    with pytest.raises(ValueError, match="unknown reorder mode"):
        reorder.reorder_permutation(batch, 3)


# ---- context specs ----

@pytest.mark.parametrize("spec_id", [0, 1, 2])
def test_spec_by_id(spec_id):
    got, want = context.spec_by_id(spec_id), jax_context.spec_by_id(spec_id)
    assert (got.spec_id, got.order) == (want.spec_id, want.order)
    rows = np.random.default_rng(spec_id).integers(0, 7, (4, 50), dtype=np.uint8)
    assert got.num_contexts(7) == want.num_contexts(7)
    np.testing.assert_array_equal(got.contexts(rows, 7), want.contexts(rows, 7))


# ---- debug dumps ----

def test_debug_outputs():
    rng = np.random.default_rng(2)
    n = 2000
    lcp = rng.integers(0, 30, n).astype(np.int32)
    bwt = rng.integers(0, 6, n, dtype=np.uint8)
    sub = rng.integers(0, 6, n, dtype=np.uint8)
    qs = rng.integers(33, 75, n, dtype=np.uint8)
    qs2 = rng.integers(33, 75, n, dtype=np.uint8)
    cfg, jcfg = config.SmoothConfig(), jax_config.SmoothConfig()
    for got, want in zip(debug.lcp_bitvectors(lcp, 16), jax_lcp_bitvectors(lcp, 16)):
        np.testing.assert_array_equal(got, want)
    a, b = io.StringIO(), io.StringIO()
    debug.position_dump(bwt, sub, qs, qs2, lcp, cfg, a, limit=500)
    jax_debug.position_dump(bwt, sub, qs, qs2, lcp, jcfg, b, limit=500)
    assert a.getvalue() == b.getvalue()
    assert debug.qs_distribution(qs, bwt != 0) == jax_debug.qs_distribution(qs, bwt != 0)
    hist = debug.cluster_size_histogram(lcp, cfg)
    np.testing.assert_array_equal(hist, jax_debug.cluster_size_histogram(lcp, jcfg))
    assert debug.format_histogram(hist) == jax_debug.format_histogram(hist)


# ---- CLI parser ----

def _actions(parser):
    return {a.dest: a for a in parser._actions}


_JAX_ACTIONS = _actions(jax_cli.build_parser())


@pytest.mark.parametrize("dest", sorted(_JAX_ACTIONS))
def test_cli_parser_action(dest):
    got, want = _actions(cli.build_parser()).get(dest), _JAX_ACTIONS[dest]
    assert got is not None, f"the port's parser has no {dest}"
    for attr in ("option_strings", "default", "nargs", "choices", "type", "const",
                 "required", "metavar", "help"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert type(got) is type(want)


def test_cli_parser_has_no_extra_action():
    assert set(_actions(cli.build_parser())) == set(_JAX_ACTIONS)


@pytest.mark.parametrize("argv", [["in.fq"], ["a.fq", "b.fq", "-p", "-o", "x", "--m3", "-M", "1"],
                                  ["in.fq", "--ext-mem", "--mem", "512", "-0", "--cpu"]])
def test_cli_parses_alike(argv):
    assert vars(cli.build_parser().parse_args(argv)) == vars(jax_cli.build_parser().parse_args(argv))


# ---- FASTQ check ----

@pytest.mark.parametrize("path", ["a.fastq", "a.fq", "dir.fq/a.txt", "a.FASTQ", "fastq", "a.fq.gz", ""])
def test_check_extension(path):
    assert checkfastq.check_extension(path) == jax_checkfastq.check_extension(path)


# ---- variant proxy: simulator, pileup, caller, scoring ----

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_simulate_diploid(seed):
    got = variant_proxy.simulate_diploid(3000, 101, 20_000, 12, seed)
    want = jax_variant_proxy.simulate_diploid(3000, 101, 20_000, 12, seed)
    for field in ("genome", "snp_pos", "snp_alt", "starts", "strands", "haps"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype and np.array_equal(g, w), field
    for field in ("seqs", "quals", "lengths"):
        g, w = getattr(got.batch, field), getattr(want.batch, field)
        assert g.dtype == w.dtype and np.array_equal(g, w), field


def test_simulate_diploid_refuses_dense_snps_alike():
    with pytest.raises(ValueError) as want:
        jax_variant_proxy.simulate_diploid(10, 101, 2_000, 20)
    with pytest.raises(ValueError) as got:
        variant_proxy.simulate_diploid(10, 101, 2_000, 20)
    assert str(got.value) == str(want.value)


def _ragged_reads(rng, n_reads: int, width: int, glen: int):
    """Reads of random lengths 1..width with N codes and padding past each
    length, on random strands."""
    lengths = rng.integers(1, width + 1, n_reads).astype(np.int32)
    seqs = rng.choice(np.array([1, 2, 3, 4, 5], np.uint8), size=(n_reads, width),
                      p=[0.23, 0.23, 0.23, 0.08, 0.23])
    seqs[np.arange(width)[None, :] >= lengths[:, None]] = 0
    batch = fastq.ReadBatch(seqs=seqs, quals=np.full((n_reads, width), 40, np.uint8), lengths=lengths)
    starts = (rng.integers(0, glen - width, n_reads)).astype(np.int64)
    return batch, starts, rng.random(n_reads) < 0.5


@pytest.mark.parametrize("case", ["simulated", "ragged_with_n"])
def test_pileup_counts(case):
    if case == "simulated":
        glen = 20_000
        sim = jax_variant_proxy.simulate_diploid(3000, 101, glen, 12, seed=4)
        batch, starts, strands = sim.batch, sim.starts, sim.strands
    else:
        glen = 5_000
        batch, starts, strands = _ragged_reads(np.random.default_rng(5), 2000, 150, glen)
        assert (batch.seqs == 4).any() and (batch.lengths < 150).any()
    got = variant_proxy.pileup_counts(batch, starts, strands, glen, device="cpu")
    want = jax_variant_proxy.pileup_counts(batch, starts, strands, glen)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kwargs", [{}, {"min_depth": 3, "min_alt": 2, "alt_frac": 0.1}])
def test_call_snps_and_evaluate(kwargs):
    rng = np.random.default_rng(6)
    glen = 5_000
    counts = rng.poisson(3.0, (glen, 4)).astype(np.int64)
    genome = rng.integers(0, 4, glen).astype(np.int8)
    counts[np.arange(glen), genome] += rng.integers(0, 30, glen)
    got = variant_proxy.call_snps(counts, genome, **kwargs)
    want = jax_variant_proxy.call_snps(counts, genome, **kwargs)
    assert got == want and got
    calls = list(got.items())
    snp_pos = np.array([p for p, _ in calls[::2]] + [glen - 1], np.int64)
    snp_alt = np.array([a if i % 4 else (a + 1) % 4 for i, (_, a) in enumerate(calls[::2])] + [0],
                       np.int8)
    assert (variant_proxy.evaluate(got, snp_pos, snp_alt)
            == jax_variant_proxy.evaluate(want, snp_pos, snp_alt))

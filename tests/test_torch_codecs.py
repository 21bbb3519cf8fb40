"""The port's jax-free host codecs against the JAX package: the numpy rANS
coder is byte-equal to the lax.scan coder, each package decodes the other's
containers, the native-backed choices and the BQZH header codec give the same
bytes, and old BQZE archives decode through the port's LF walk, on the card
unless the CPU is asked for."""

import numpy as np
import pytest
import torch

from bfqzip_tpu.io.fastq import read_fastq
from bfqzip_tpu.models import dna_ebwt as jax_dna_ebwt
from bfqzip_tpu.models import headers as jax_headers
from bfqzip_tpu.models.context import Order0Spec, Order1Spec, Order2Spec
from bfqzip_tpu.ops import rans as jax_rans
from bfqzip_tpu_torch.utils import native
from bfqzip_tpu_torch.models import dna_ebwt, headers
from bfqzip_tpu_torch.ops import rans
from bfqzip_tpu_torch.pipeline import decompress_stream

from conftest import golden_path
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

LANES = (8, 64, 1024)


def _streams():
    rng = np.random.default_rng(11)
    lines = open(golden_path("example.m2b0.fq"), "rb").read().split(b"\n")
    return {
        "empty": b"",
        "one": b"G",
        "random": rng.integers(0, 256, 6000).astype(np.uint8).tobytes(),
        "dna": b"\n".join(lines[1::4]) + b"\n",
        "qs": b"\n".join(lines[3::4]) + b"\n",
    }


STREAMS = _streams()


@pytest.fixture(scope="module")
def native_lib():
    if not (native.available() and native.cm_available()):
        pytest.fail("the native codec library did not build (make -C native)")
    return native


@pytest.mark.parametrize("spec", [Order0Spec, Order1Spec, Order2Spec], ids=lambda s: f"o{s.order}")
@pytest.mark.parametrize("name", list(STREAMS))
def test_numpy_encode_is_byte_equal_to_jax(name, spec):
    data = STREAMS[name]
    for lanes in LANES:
        got = rans.encode(data, spec, lanes)
        assert got == jax_rans.encode(data, spec, lanes), lanes
        # each package decodes the other's containers
        assert bytes(jax_rans.decode(got)) == data
        assert bytes(rans.decode(jax_rans.encode(data, spec, lanes))) == data


def test_choose_spec_and_quantize_match_jax():
    rng = np.random.default_rng(3)
    for data in STREAMS.values():
        arr = np.frombuffer(data, np.uint8)
        got, want = rans.choose_spec(arr), jax_rans.choose_spec(arr)
        assert (got.spec_id, got.order) == (want.spec_id, want.order)
    counts = rng.integers(0, 50, (7, 9)) * (rng.random((7, 9)) < 0.6)
    counts[2] = 0  # an unseen context
    assert np.array_equal(rans.quantize_freqs(counts), jax_rans.quantize_freqs(counts))
    for n in (0, 1, 4096, 10**6):
        assert rans._auto_lanes(n, 1024) == jax_rans._auto_lanes(n, 1024)


@pytest.mark.parametrize("name", ["random", "dna", "qs"])
def test_native_choices_match_jax(native_lib, monkeypatch, name):
    data = STREAMS[name]
    best = rans.encode_best(data)
    assert best == jax_rans.encode_best(data)
    assert bytes(rans.decode(best)) == data
    # without the native library, encode_best's numpy choice writes the same container
    with monkeypatch.context() as m:
        m.setattr(native, "available", lambda: False)
        assert rans.encode_best(data) == best
    for pos_reset in (-1, ord("\n")):
        blob = rans.encode_blob_best(data, pos_reset=pos_reset)
        assert blob == jax_rans.encode_blob_best(data, pos_reset=pos_reset)
        assert bytes(rans.decode_blob(blob)) == data
        assert bytes(jax_rans.decode_blob(blob)) == data


def test_decode_blob_rejects_foreign_magic():
    with pytest.raises(ValueError, match="rANS"):
        rans.decode_blob(b"XXXX" + bytes(40))


_HEADER_SETS = {
    "golden": read_fastq(golden_path("example.in.fastq")).headers,
    "synth_var": read_fastq(golden_path("synth_var.in.fastq")).headers,
    "nonuniform": [b"@read_one", b"@2 another kind", b"@x 9 9 9"],
    "fixed_width_zeros": [b"@s.%04d x" % i for i in (1, 7, 42, 999)],
    "mixed_width_zeros": [b"@a.007", b"@a.1000", b"@a.08"],
    "overlong": [b"@x 123456789012345678901234567890", b"@x 99999999999999999999"],
    "empty": [],
}


@pytest.mark.parametrize("name", list(_HEADER_SETS))
def test_headers_byte_equal_to_jax(native_lib, name):
    hdrs = _HEADER_SETS[name]
    blob = headers.encode_headers(hdrs)
    assert blob == jax_headers.encode_headers(hdrs)
    assert headers.decode_headers(blob) == hdrs
    assert jax_headers.decode_headers(blob) == hdrs


def test_decode_dna_stream_of_jax_container():
    lines = open(golden_path("synth_var.m2b0.fq"), "rb").read().split(b"\n")
    data = b"\n".join(lines[1::4]) + b"\n"
    blob = jax_dna_ebwt.encode_dna_stream(data)
    assert blob[:4] == b"BQZE"
    assert dna_ebwt.decode_dna_stream(blob, device="cpu") == data
    with pytest.raises(ValueError, match="EBWT container"):
        dna_ebwt.decode_dna_stream(b"BQZR" + blob[4:], device="cpu")


def test_bqze_decodes_on_the_card_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    """With no device the BQZE decoder and decompress_stream invert on
    `cuda`, so without a card they raise; device="cpu" decodes."""
    lines = open(golden_path("example.m2b0.fq"), "rb").read().split(b"\n")
    data = b"\n".join(lines[1::4]) + b"\n"
    path = tmp_path / "dna.rans"
    path.write_bytes(jax_dna_ebwt.encode_dna_stream(data))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        dna_ebwt.decode_dna_stream(path.read_bytes())
    with pytest.raises(RuntimeError, match="cuda"):
        decompress_stream(str(path), str(tmp_path / "out"))
    assert not (tmp_path / "out").exists()
    assert open(decompress_stream(str(path), str(tmp_path / "out"), device="cpu"), "rb").read() == data

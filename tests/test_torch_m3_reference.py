"""The CLI's mode 3 (--m3) against the benchmark's plain reference: a file of
the benchmark's read model with its HiSeq read names (benchmark/gen) goes
through cli.main --m3; its .fq, .fq.dna, .fq.qs and .h are byte-equal to
benchmark/reference/streams.py over benchmark/reference/ebwt.py's
smoothing, with and without -B; --restore of its three archives gives the
.fq back byte for byte; and step 5's counter (`pipeline.codec_streams`)
agrees with the files on disk.  Nothing here imports JAX or the JAX package."""

import json
import os
import sys

import numpy as np
import pytest

from bfqzip_tpu_torch import cli, pipeline
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

from gen import headers as gen_headers  # noqa: E402
from gen import reads as gen  # noqa: E402
from reference import ebwt as ref  # noqa: E402
from reference import streams as ref_streams  # noqa: E402

with open(os.path.join(BENCH, "configs", "hiseq101m3.json")) as f:
    CONFIG = json.load(f)
READS = dict(CONFIG["reads"], count=3000)
STREAMS = (".fq.dna", ".fq.qs", ".h")


@pytest.mark.parametrize("binning", [False, True], ids=["B0", "B1"])
@pytest.mark.parametrize("seed", [2**31 + 21, 2**33 + 22])
def test_m3_streams_and_restore_equal_the_reference(tmp_path, capsys, seed, binning):
    seqs, quals, lengths = gen.make(READS, seed, "cpu")
    names = gen_headers.make(CONFIG["headers"], READS["count"], seed)
    src = str(tmp_path / "in.fastq")
    with open(src, "wb") as f:
        f.write(ref_streams.fastq_bytes(seqs, quals, lengths, names))
    base = str(tmp_path / "out")
    assert cli.main([src, "-o", base, "--m3", "--cpu"] + ["-B"] * binning) == 0

    want = ref.smooth_reads(seqs, quals, lengths, dict(CONFIG["smooth"], binning=binning))
    expected = ref_streams.m3_streams(want["seqs"], want["quals"], lengths, names)
    for ext, data in expected.items():
        with open(base + ext, "rb") as f:
            assert f.read() == data, ext

    restored = str(tmp_path / "restored.fastq")
    assert cli.main([base, "--restore", "-o", restored, "--cpu"]) == 0
    with open(restored, "rb") as f:
        assert f.read() == expected[".fq"]
    capsys.readouterr()

    # one record a stream of this file alone (step 5 clears the earlier
    # files'), each agreeing with the stream and its archive on disk
    assert len(pipeline.codec_streams) == len(STREAMS)
    records = {os.path.basename(r["stream"])[3:]: r for r in pipeline.codec_streams}
    assert sorted(records) == sorted(STREAMS)
    for ext, r in records.items():
        assert r["in_bytes"] == os.path.getsize(base + ext)
        assert r["out_bytes"] == os.path.getsize(base + ext + ".rans")
        with open(base + ext + ".rans", "rb") as f:
            assert f.read(4) == r["container"][:4].encode()
    assert records[".h"]["container"] == "BQZH"
    # the read number, x and y vary (the tile too where the file crosses
    # two); the run, instrument and flowcell do not
    assert records[".h"]["fields"]["numeric"] >= 3 and records[".h"]["fields"]["varying"] == 0
    archive = sum(os.path.getsize(base + ext + ".rans") for ext in STREAMS)
    ratio = sum(r["out_bytes"] for r in records.values()) / os.path.getsize(src)
    assert ratio == archive / os.path.getsize(src) < 0.2


def test_field_kinds_and_container_names():
    from bfqzip_tpu_torch.models import headers
    from bfqzip_tpu_torch.ops import rans

    names = [b"@r.%d x:%d %s" % (i, 7, b"ab"[i % 2:i % 2 + 1]) for i in range(50)]
    assert headers.field_kinds(headers.encode_headers(names)) == {
        "constant": 2, "numeric": 2, "varying": 1}  # '@r.', ' x:'; i, 7; ' a' / ' b'
    ragged = [b"@a", b"@b:1"]
    assert headers.field_kinds(headers.encode_headers(ragged)) == {"fallback": 1}
    data = bytes(range(10)) * 400
    for spec in (rans.Order0Spec, rans.Order1Spec, rans.Order2Spec):
        assert rans.container_name(rans.encode(data, spec)) == "BQZR/o%d" % spec.order
    assert rans.container_name(b"BQZC" + bytes(8)) == "BQZC"


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
def test_tables_past_64_symbols_decode(monkeypatch, use_native):
    """Forty common symbols and two hundred seen once: each rare one is
    raised to frequency 1, and the order-0 table owes more than its top
    symbol holds.  The repaired table tiles M with every symbol at 1 or more,
    and encode_best's container decodes to the data (the native coder alone
    writes a table that does not)."""
    from bfqzip_tpu_torch.ops import rans
    from bfqzip_tpu_torch.utils import native

    rng = np.random.default_rng(5)
    data = np.concatenate([np.repeat(np.arange(40, dtype=np.uint8), 1000),
                           np.arange(40, 240, dtype=np.uint8)])
    rng.shuffle(data)
    counts = np.bincount(data, minlength=256)[None, np.unique(data)]
    freq = rans.quantize_freqs(counts).astype(np.int64)
    assert freq.sum() == rans.M and freq.min() >= 1
    assert rans._quantize(counts)[1]  # the repair was needed
    if not use_native:
        monkeypatch.setattr(native, "available", lambda: False)
    blob = rans.encode_best(data)
    assert np.array_equal(rans.decode(blob), data)
    assert np.array_equal(rans.decode_blob(rans.encode_blob_best(data)), data)


def test_threads_asking_for_the_native_library_at_once_all_get_it(monkeypatch):
    """Step 5's streams may be the first to ask for the native library in a
    process, all at once: none may take the NumPy fallback (or lose BQZC)
    while another thread is loading it."""
    import ctypes
    import threading
    import time
    from concurrent.futures import ThreadPoolExecutor

    from bfqzip_tpu_torch.utils import native

    assert native.available()
    real, loads = ctypes.CDLL, []

    def slow_cdll(path, *args, **kwargs):
        loads.append(threading.get_ident())
        time.sleep(0.2)
        return real(path, *args, **kwargs)

    monkeypatch.setattr(native, "_SEARCHED", False)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native.ctypes, "CDLL", slow_cdll)
    with ThreadPoolExecutor(4) as pool:
        got = list(pool.map(lambda _: native.cm_available(), range(4)))
    assert got == [True] * 4 and len(loads) == 1

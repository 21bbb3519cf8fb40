"""The port's pipeline against the JAX pipeline on example.in.fastq: every
output file except the .log is byte-equal for modes 1, 2, 3 and binning;
the stage-1 artifact cache (hit, rebuild, invalidation, and artifacts shared
in both directions); the CLI's .fq through the native formatter and without
it; restore / decompress round trips; the -D dump; the
out-of-core route; the 6 long-read goldens through the artifacts; and the
sequence-sharded mesh route over 4 gloo ranks."""

import os
import shutil

import pytest

from bfqzip_tpu.config import PipelineConfig, SmoothConfig
from bfqzip_tpu_torch.utils import native
from bfqzip_tpu.pipeline import restore_fastq as jax_restore_fastq
from bfqzip_tpu.pipeline import run_pipeline as jax_run_pipeline
from bfqzip_tpu_torch import cli
from bfqzip_tpu_torch.io import fastq
from bfqzip_tpu_torch.parallel import mesh
from bfqzip_tpu_torch.pipeline import decompress_stream, restore_fastq, run_pipeline

from conftest import golden_path
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

CFGS = {
    "m1": PipelineConfig(mode=1),
    "m2": PipelineConfig(mode=2),
    "m3": PipelineConfig(mode=3),
    "m2B": PipelineConfig(smooth=SmoothConfig(binning=True), mode=2),
}


def outputs(base):
    """{suffix: bytes} of every file the run wrote at `base`, except the log."""
    d, stem = os.path.split(base)
    got = {}
    for name in os.listdir(d):
        if name.startswith(stem + ".") or name.startswith(stem + "_"):
            suffix = name[len(stem):]
            if suffix != ".log":
                with open(os.path.join(d, name), "rb") as f:
                    got[suffix] = f.read()
    return got


def assert_same_outputs(torch_base, jax_base):
    got, want = outputs(torch_base), outputs(jax_base)
    assert sorted(got) == sorted(want)
    for suffix in want:
        assert got[suffix] == want[suffix], suffix


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One JAX and one port run per configuration, shared by the tests."""
    done = {}

    def get(tag):
        if tag not in done:
            d = tmp_path_factory.mktemp(tag)
            src = str(d / "reads.fastq")
            shutil.copyfile(golden_path("example.in.fastq"), src)
            jres = jax_run_pipeline([src], CFGS[tag], out_base=str(d / "jax"))
            tres = run_pipeline([src], CFGS[tag], out_base=str(d / "torch"), device="cpu")
            done[tag] = (d, jres, tres)
        return done[tag]

    return get


@pytest.mark.parametrize("tag", list(CFGS))
def test_outputs_byte_equal_to_jax(runs, tag):
    d, jres, tres = runs(tag)
    assert_same_outputs(str(d / "torch"), str(d / "jax"))
    assert tres.stats == jres.stats and tres.stats["num_clust"] > 0
    assert [os.path.basename(p) for p in tres.streams] == \
        [os.path.basename(p).replace("jax", "torch", 1) for p in jres.streams]
    assert sorted(tres.outputs) == sorted(jres.outputs) == ["rans"]
    assert [p["phase"] for p in tres.report["phases"]] == \
        [p["phase"].replace("jax", "torch") for p in jres.report["phases"]]


def test_mode3_fq_is_the_golden(runs):
    d, _, _ = runs("m3")
    with open(golden_path("example.m2b0h.fq"), "rb") as f:
        assert open(d / "torch.fq", "rb").read() == f.read()


@pytest.mark.parametrize("tag", ["m1", "m2", "m3"])
def test_restore_and_decompress_round_trip(runs, tag):
    d, jres, tres = runs(tag)
    base = str(d / "torch")
    out = restore_fastq(base, str(d / "restored.fastq"))
    want = jax_restore_fastq(base, str(d / "restored_jax.fastq"))
    fq = open(base + ".fq", "rb").read()
    assert open(out, "rb").read() == fq == open(want, "rb").read()
    for stream in tres.streams:
        got = decompress_stream(stream + ".rans", stream + ".rt")
        assert open(got, "rb").read() == open(stream, "rb").read()


def _set_old(path):
    os.utime(path, ns=(0, 0))


def test_artifact_cache_hit_rebuild_and_invalidation(tmp_path):
    src = str(tmp_path / "reads.fastq")
    shutil.copyfile(golden_path("example.in.fastq"), src)
    base = str(tmp_path / "out")
    run_pipeline([src], PipelineConfig(mode=0), out_base=base, device="cpu")
    _set_old(base + ".bwt")
    # a second run reuses the artifacts
    run_pipeline([src], PipelineConfig(mode=0), out_base=base, device="cpu")
    assert os.stat(base + ".bwt").st_mtime_ns == 0
    assert "artifacts cached" in open(base + ".log").read()
    # rebuild forces step 1
    run_pipeline([src], PipelineConfig(mode=0, rebuild=True), out_base=base, device="cpu")
    assert os.stat(base + ".bwt").st_mtime_ns != 0
    # a changed input under the same name invalidates the artifacts
    _set_old(base + ".bwt")
    shutil.copyfile(golden_path("synth_var.in.fastq"), src)
    run_pipeline([src], PipelineConfig(mode=0), out_base=base, device="cpu")
    assert os.stat(base + ".bwt").st_mtime_ns != 0
    with open(golden_path("synth_var.m2b0.fq"), "rb") as f:
        assert open(base + ".fq", "rb").read() == f.read()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_artifacts_shared_between_packages(tmp_path, writer):
    """Artifacts written by one package are consumed by the other."""
    src = str(tmp_path / "reads.fastq")
    shutil.copyfile(golden_path("example.in.fastq"), src)
    base = str(tmp_path / "out")
    cfg = PipelineConfig(mode=0)
    runs = {"jax": lambda: jax_run_pipeline([src], cfg, out_base=base),
            "torch": lambda: run_pipeline([src], cfg, out_base=base, device="cpu")}
    runs[writer]()
    for ext in (".bwt", ".bwt.qs", ".lcp", ".meta.json"):
        _set_old(base + ext)
    os.remove(base + ".fq")
    runs["torch" if writer == "jax" else "jax"]()
    assert os.stat(base + ".bwt").st_mtime_ns == 0, "artifacts were rebuilt"
    with open(golden_path("example.m2b0.fq"), "rb") as f:
        assert open(base + ".fq", "rb").read() == f.read()


def test_debug_dump_equal_to_jax(tmp_path):
    src = str(tmp_path / "reads.fastq")
    shutil.copyfile(golden_path("example.in.fastq"), src)
    cfg = PipelineConfig(mode=0)
    jax_run_pipeline([src], cfg, out_base=str(tmp_path / "jax"), debug_dump=True)
    run_pipeline([src], cfg, out_base=str(tmp_path / "torch"), debug_dump=True, device="cpu")
    got = open(tmp_path / "torch.debug.tsv", "rb").read()
    assert got == open(tmp_path / "jax.debug.tsv", "rb").read()
    assert got.count(b"\n") == 10201
    log = open(tmp_path / "torch.log").read()
    assert "cluster-size histogram" in log and "QS distribution after" in log


def test_original_copies_input(tmp_path):
    src = str(tmp_path / "reads.fastq")
    shutil.copyfile(golden_path("example.in.fastq"), src)
    cfg = PipelineConfig(mode=1, original=True)
    jax_run_pipeline([src], cfg, out_base=str(tmp_path / "jax"))
    run_pipeline([src], cfg, out_base=str(tmp_path / "torch"), device="cpu")
    assert_same_outputs(str(tmp_path / "torch"), str(tmp_path / "jax"))
    assert open(tmp_path / "torch.fq", "rb").read() == open(src, "rb").read()


def test_cli_fq_through_the_native_formatter(tmp_path, monkeypatch):
    """`-0` writes its .fq once through the native formatter when the
    library loads, once through numpy when it does not, both the golden."""
    if not native.available():
        pytest.skip("native library not built")
    src = str(tmp_path / "reads.fastq")
    shutil.copyfile(golden_path("example.in.fastq"), src)
    with open(golden_path("example.m2b0.fq"), "rb") as f:
        golden = f.read()
    for route in ("native", "numpy"):
        if route == "numpy":
            monkeypatch.setattr(native, "available", lambda: False)
        before = dict(fastq.format_calls)
        assert cli.main([src, "-o", str(tmp_path / route), "-0", "--cpu"]) == 0
        assert fastq.format_calls == dict(before, **{route: before[route] + 1})
        assert open(tmp_path / f"{route}.fq", "rb").read() == golden


def test_mesh_route_byte_equal_to_jax(tmp_path, monkeypatch):
    """mesh_shards=4 on the CPU: steps 1-3 on ONE global EBWT over 4 gloo
    ranks; every file equals the JAX pipeline's on its 4-device mesh."""
    monkeypatch.setattr(mesh, "JOIN_TIMEOUT_S", 120)  # a hang fails the test
    src = str(tmp_path / "reads.fastq")
    shutil.copyfile(golden_path("example.in.fastq"), src)
    cfg = PipelineConfig(mode=2)
    jres = jax_run_pipeline([src], cfg, out_base=str(tmp_path / "jax"), mesh_shards=4)
    tres = run_pipeline([src], cfg, out_base=str(tmp_path / "torch"), device="cpu", mesh_shards=4)
    assert_same_outputs(str(tmp_path / "torch"), str(tmp_path / "jax"))
    assert tres.stats == jres.stats and tres.stats["num_clust"] > 0
    assert "steps1-3: sequence-sharded over 4 ranks" in open(tmp_path / "torch.log").read()
    assert len(tres.report["sharded"]) == 4


@pytest.mark.skipif(not native.ext_merge_available(), reason="native library not built")
@pytest.mark.parametrize("mode", [2, 3])
def test_ext_mem_route_byte_equal_to_jax(tmp_path, monkeypatch, mode):
    """ext_mem_mb: spill-backed parse, steps 1-3 in smooth_fastq_external,
    then steps 4-5; every file and the stats are the JAX pipeline's."""
    src = str(tmp_path / "reads.fastq")
    shutil.copyfile(golden_path("example.in.fastq"), src)
    cfg = PipelineConfig(mode=mode)
    jres = jax_run_pipeline([src], cfg, out_base=str(tmp_path / "jax"), ext_mem_mb=1)
    tres = run_pipeline([src], cfg, out_base=str(tmp_path / "torch"), device="cpu", ext_mem_mb=1)
    assert_same_outputs(str(tmp_path / "torch"), str(tmp_path / "jax"))
    assert tres.stats == jres.stats and tres.stats["num_clust"] > 0
    assert [p["phase"] for p in tres.report["phases"]] == \
        [p["phase"].replace("jax", "torch") for p in jres.report["phases"]]
    # without the native merge the route raises; it never runs in-core
    monkeypatch.setattr(native, "ext_merge_available", lambda: False)
    with pytest.raises(RuntimeError, match="native"):
        run_pipeline([src], cfg, out_base=str(tmp_path / "again"), device="cpu", ext_mem_mb=1)
    assert not os.path.exists(tmp_path / "again.fq")


_LONG = {"m0b0": SmoothConfig(mode=0), "m1b0": SmoothConfig(mode=1), "m2b0": SmoothConfig(),
         "m3b0": SmoothConfig(mode=3), "m2b1": SmoothConfig(binning=True), "m2b0h": SmoothConfig()}


@pytest.mark.parametrize("tag", list(_LONG))
def test_long_read_goldens_through_the_artifacts(tmp_path, tag):
    """synth_long (400-600 bp): step 1's doubling build writes the artifacts,
    and step 3 (lf_array, smooth, LF walk) reproduces the golden."""
    src = str(tmp_path / "reads.fastq")
    shutil.copyfile(golden_path("synth_long.in.fastq"), src)
    cfg = PipelineConfig(smooth=_LONG[tag], mode=0, headers=tag.endswith("h"))
    run_pipeline([src], cfg, out_base=str(tmp_path / "o"), device="cpu")
    with open(golden_path(f"synth_long.{tag}.fq"), "rb") as f:
        assert open(tmp_path / "o.fq", "rb").read() == f.read()

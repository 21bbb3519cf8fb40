"""The port's spans (utils/profiling.span): nothing recorded or opened while
recording is off; parent, call and self time inside recording(), children
on worker threads included; the profiler's annotations of smooth_fastq
nested as the spans are, on the spans' clock; the CLI's spans with its
OUT.log unchanged; --m3's step 4 and step 5 spans, each stream's on a pool
thread; the out-of-core route's spans, one a chunk and one a segment, and
its spill counter; the sharded path's reports built only when asked for;
and the benchmark's span readers on hand-made span lists."""

import ast
import importlib.util
import json
import os
import shutil
import sys
import threading
import time

import numpy as np
import pytest
import torch

from bfqzip_tpu_torch import cli, external, pipeline
from bfqzip_tpu_torch.config import SmoothConfig
from bfqzip_tpu_torch.engine import smooth_fastq
from bfqzip_tpu_torch.io.fastq import read_fastq
from bfqzip_tpu_torch.parallel import mesh
from bfqzip_tpu_torch.utils import profiling

import torch_ranks
from conftest import golden_path
from torch_cpu import one_torch_thread  # noqa: F401  (autouse)

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")

# parent -> children of one smooth_fastq call (the flat build)
SMOOTH_FASTQ_TREE = {
    "engine.smooth_fastq": ["engine.upload", "suffix.build_ebwt", "smooth.smooth",
                            "invert.invert_via_sa", "engine.download"],
    "suffix.build_ebwt": ["suffix.pack", "suffix.sort_lsd", "suffix.post", "suffix.lcp"],
    "smooth.smooth": ["smooth.cluster_words", "smooth.broadcast_words", "smooth.apply_words"],
}


@pytest.fixture(autouse=True)
def no_spans():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _children(spans) -> dict:
    by_id = {s["id"]: s["name"] for s in spans}
    tree = {}
    for s in spans:
        if s["parent"] is not None:
            tree.setdefault(by_id[s["parent"]], []).append(s["name"])
    return tree


# ---- the facility ----

def test_off_records_and_opens_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("opened while recording is off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert profiling.span("a") is profiling.span("b")  # one shared null context
    with profiling.span("a") as sp:
        with profiling.span("b"):
            pass
    assert sp is None
    assert profiling.spans() == []


def test_timed_span_keeps_its_times_but_records_nothing(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", lambda *a: pytest.fail("opened"))
    with profiling.span("stage", timed=True) as sp:
        time.sleep(0.002)
    assert sp.device_ms is None and sp.ms == sp.host_ms >= 2.0
    assert profiling.spans() == []


def test_nesting_ids_and_self_time():
    with profiling.recording():
        with profiling.span("call"):
            time.sleep(0.002)
            with profiling.span("first"):
                time.sleep(0.003)
                with profiling.span("inner"):
                    time.sleep(0.002)
            with profiling.span("second"):
                time.sleep(0.002)
        with profiling.span("next_call"):
            pass
    with profiling.span("after"):  # recording is off again
        pass
    spans = profiling.spans()
    by = {s["name"]: s for s in spans}
    assert [s["name"] for s in spans] == ["call", "first", "inner", "second", "next_call"]
    call = by["call"]
    assert call["parent"] is None and call["call"] == call["id"]
    assert by["first"]["parent"] == by["second"]["parent"] == call["id"]
    assert by["inner"]["parent"] == by["first"]["id"]
    assert {by[n]["call"] for n in ("first", "inner", "second")} == {call["id"]}
    assert by["next_call"]["call"] == by["next_call"]["id"] != call["id"]
    for s in spans:
        assert s["host_ms"] == pytest.approx((s["end_ns"] - s["start_ns"]) / 1e6)
        assert s["device_ms"] is None
    assert call["self_ms"] == pytest.approx(call["host_ms"] - by["first"]["host_ms"]
                                            - by["second"]["host_ms"])
    assert by["first"]["self_ms"] == pytest.approx(by["first"]["host_ms"] - by["inner"]["host_ms"])
    assert by["inner"]["self_ms"] == pytest.approx(by["inner"]["host_ms"])
    assert call["self_ms"] >= 2.0 and by["first"]["self_ms"] >= 3.0


def test_children_on_other_threads_count_once():
    """Two children opened at once on two threads, each handed the parent:
    both take its id and call, their own children nest under them, and the
    parent's self time is its host time less the union of theirs."""
    both_open = threading.Barrier(2)

    def child(name, parent):
        with profiling.span(name, parent=parent):
            both_open.wait(timeout=10)
            time.sleep(0.02)
            with profiling.span(name + ".inner"):
                time.sleep(0.002)

    with profiling.recording():
        with profiling.span("call"):
            with profiling.span("parent") as parent:
                threads = [threading.Thread(target=child, args=(n, parent)) for n in ("a", "b")]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=10)
                assert not any(t.is_alive() for t in threads)
                time.sleep(0.005)
    by = {s["name"]: s for s in profiling.spans()}
    call, parent = by["call"], by["parent"]
    for name in ("a", "b"):
        assert by[name]["parent"] == parent["id"] and by[name]["call"] == call["id"]
        assert by[name + ".inner"]["parent"] == by[name]["id"]
        assert by[name + ".inner"]["call"] == call["id"]
    a, b = by["a"], by["b"]
    union_ms = (max(a["end_ns"], b["end_ns"]) - min(a["start_ns"], b["start_ns"])) / 1e6
    assert union_ms < a["host_ms"] + b["host_ms"]  # they ran at once
    assert parent["self_ms"] == pytest.approx(parent["host_ms"] - union_ms)
    assert parent["self_ms"] >= 5.0


def _profiled_smooth_fastq(batch, path: str):
    """(spans, annotations): one smooth_fastq under torch.profiler on the
    CPU, its recorded spans and its Chrome trace's bfq.* annotations, both
    in start order, the annotations' ts and dur in microseconds of Unix time."""
    profiling.clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("warm-up"):  # a profiler's first annotation is slow
            pass
        smooth_fastq(batch, SmoothConfig(), device="cpu")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    base_us = trace.get("baseTimeNanoseconds", 0) / 1e3
    marks = sorted(({"name": e["name"], "ts": e["ts"] + base_us, "dur": e["dur"]}
                    for e in trace["traceEvents"] if e.get("ph") == "X"
                    and e.get("cat") == "user_annotation" and e["name"].startswith("bfq.")),
                   key=lambda e: e["ts"])
    return profiling.spans(), marks


def test_smooth_fastq_annotations_nest_on_the_spans_clock(tmp_path):
    """The annotations nest as the spans do, and start where the spans
    start.  A stamp on a busy host can land tens of microseconds off when
    the thread is held up inside the annotation's opening call, so the 50 us
    agreement is asked of one of a few calls, and 0.1 s of every call: any
    other clock is off by far more."""
    batch = read_fastq(golden_path("example.in.fastq"))
    path = str(tmp_path / "trace.json")
    _profiled_smooth_fastq(batch, path)  # warm-up: the first annotation of a process is slower
    worst = []
    for _ in range(5):
        spans, marks = _profiled_smooth_fastq(batch, path)
        assert {k: v for k, v in _children(spans).items() if k in SMOOTH_FASTQ_TREE} == SMOOTH_FASTQ_TREE
        assert [e["name"] for e in marks] == ["bfq." + s["name"] for s in spans]
        interval = {s["id"]: (e["ts"], e["ts"] + e["dur"]) for e, s in zip(marks, spans)}
        for s in spans:  # each annotation lies inside its parent's
            if s["parent"] is not None:
                (lo, hi), (plo, phi) = interval[s["id"]], interval[s["parent"]]
                assert plo <= lo and hi <= phi, s["name"]
        offsets = [abs(e["ts"] - s["start_ns"] / 1e3) for e, s in zip(marks, spans)]
        assert max(offsets) < 1e5, offsets
        worst.append(max(offsets))
        if worst[-1] < 50:
            break
    assert min(worst) < 50, worst


def _load(kind: str, name: str):
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    spec = importlib.util.spec_from_file_location(f"spans_test_{kind}_{name}".replace(".", "_"),
                                                  os.path.join(BENCH, kind, name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_cli_spans_and_unchanged_log(tmp_path):
    src = str(tmp_path / "reads.fastq")
    shutil.copyfile(golden_path("example.in.fastq"), src)
    base = str(tmp_path / "out")
    with profiling.recording():
        assert cli.main([src, "-o", base, "-0", "--cpu"]) == 0
    spans = profiling.spans()
    root = spans[0]
    assert root["name"] == "cli.main" and root["parent"] is None
    assert all(s["call"] == root["id"] for s in spans)
    names = [s["name"] for s in spans]
    assert names.count("pipeline.fingerprint") == 1  # step 1's meta: a fresh base has no cache to check
    assert names.count("pipeline.write") == 5  # .bwt, .bwt.qs, .lcp, .meta.json, .fq
    for name in ("pipeline.load_artifacts", "pipeline.format_fastq", "step.read FASTQ",
                 "step.step1: EBWT+QS+LCP construction", "step.step3: cluster smoothing + inversion",
                 "engine.smooth_arrays_step", "rank.lf_and_pre", "invert.invert", "suffix.build_ebwt"):
        assert name in names
    assert 0 <= root["self_ms"] < root["host_ms"]
    phases = _load("entries", "cli_file")._phases(base + ".log")
    assert [p["phase"] for p in phases] == ["read FASTQ", "step1: EBWT+QS+LCP construction",
                                            "step3: cluster smoothing + inversion"]
    assert all(p["seconds"] >= 0 for p in phases)
    # step 3 takes step 1's arrays: one pipeline.load_artifacts, the on-card
    # cut and pad inside step 1
    by_id = {s["id"]: s["name"] for s in spans}
    loads = [s for s in spans if s["name"] == "pipeline.load_artifacts"]
    assert len(loads) == 1 and by_id[loads[0]["parent"]] == "step.step1: EBWT+QS+LCP construction"

    # a re-run on the same base reads the cached artifacts: one
    # pipeline.load_artifacts, the file reads before step 3
    os.remove(base + ".fq")
    profiling.clear_spans()
    with profiling.recording():
        assert cli.main([src, "-o", base, "-0", "--cpu"]) == 0
    spans = profiling.spans()
    names = [s["name"] for s in spans]
    assert names.count("pipeline.load_artifacts") == 1
    assert "step.step1: EBWT+QS+LCP construction" not in names
    load = next(s for s in spans if s["name"] == "pipeline.load_artifacts")
    assert load["parent"] == spans[0]["id"] and spans[0]["name"] == "cli.main"


def test_cli_m3_spans(tmp_path):
    """Step 4's and step 5's spans under cli.main: one codec.stream a stream,
    opened on step 5's pool threads with codec.compress as parent and the
    run's call; the coders' spans inside each, headers.encode inside the .h
    stream's; no self time below zero."""
    src = str(tmp_path / "reads.fastq")
    shutil.copyfile(golden_path("example.in.fastq"), src)
    opened_on = set()
    real_span = profiling.span

    def span(name, *args, **kw):
        if name == "codec.stream":
            opened_on.add(threading.get_ident())
        return real_span(name, *args, **kw)

    with profiling.recording(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(pipeline, "span", span)
        assert cli.main([src, "-o", str(tmp_path / "out"), "--m3", "--cpu"]) == 0
    assert threading.get_ident() not in opened_on
    spans = profiling.spans()
    root = spans[0]
    assert root["name"] == "cli.main" and all(s["call"] == root["id"] for s in spans)
    names = [s["name"] for s in spans]
    assert names.count("pipeline.stream_split") == names.count("codec.compress") == 1
    compress = next(s for s in spans if s["name"] == "codec.compress")
    streams = [s for s in spans if s["name"] == "codec.stream"]
    assert len(streams) == 3 and all(s["parent"] == compress["id"] for s in streams)
    inside = {s["id"]: {c["name"] for c in spans if c["parent"] == s["id"]} for s in streams}
    assert sorted(map(sorted, inside.values())) == [
        ["codec.cm", "codec.rans"], ["codec.cm", "codec.rans"], ["headers.encode"]]
    assert all(s["self_ms"] >= 0 for s in spans)


@pytest.mark.parametrize("short_disk", [False, True], ids=["spill", "short_disk"])
def test_ext_mem_spans_and_spill(tmp_path, monkeypatch, capsys, short_disk):
    """One external.sort_chunk a chunk and one external.segment a segment,
    as many as the report counts, every span under cli.main; `spill` true
    with spill files, false when the scratch disk is too short for them."""
    monkeypatch.setenv("BFQ_SPILL_DIR", str(tmp_path))
    if short_disk:
        real = shutil.disk_usage
        monkeypatch.setattr(external.shutil, "disk_usage", lambda p: real(p)._replace(free=1 << 20))
    rng = np.random.default_rng(5)
    n, width = 700, 101  # 71,400 positions: two segments, chunks of 101 reads under 2 MB
    seqs = rng.choice(np.frombuffer(b"ACGT", np.uint8), (n, width))
    quals = rng.integers(35, 75, (n, width), dtype=np.uint8)
    src = str(tmp_path / "reads.fastq")
    with open(src, "wb") as f:
        for i in range(n):
            f.write(b"@r%d\n%s\n+\n%s\n" % (i, seqs[i].tobytes(), quals[i].tobytes()))
    base = str(tmp_path / "out")
    with profiling.recording():
        assert cli.main([src, "-o", base, "-0", "--ext-mem", "--mem", "2", "-v", "1", "--cpu"]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("external: ")]
    report = ast.literal_eval(line[0][len("external: "):])
    spans = profiling.spans()
    root = spans[0]
    assert root["name"] == "cli.main" and all(s["call"] == root["id"] for s in spans)
    names = [s["name"] for s in spans]
    assert report["n_chunks"] >= 2 and report["n_segments"] >= 2
    assert names.count("external.sort_chunk") == report["n_chunks"]
    assert names.count("external.segment") == names.count("external.scatter") == report["n_segments"]
    for name in ("io.read_fastq_spill", "external.smooth_fastq", "external.pack_text",
                 "external.phase_b", "external.emit"):
        assert names.count(name) == 1, name
    call = next(s for s in spans if s["name"] == "external.smooth_fastq")
    assert all(s["parent"] == call["id"] for s in spans if s["name"].startswith("external.")
               and s is not call)
    assert report["spill"] is not short_disk
    assert (report["spill_bytes"] > 21 * n * (width + 1) // 2) is not short_disk


def test_sharded_report_only_when_asked(tmp_path):
    rng = np.random.default_rng(3)
    n, width = 32, 12
    lengths = rng.integers(4, width + 1, n).astype(np.int32)
    seqs = np.where(np.arange(width)[None, :] < lengths[:, None],
                    rng.integers(1, 5, (n, width)), 0).astype(np.uint8)
    quals = np.where(seqs > 0, rng.integers(35, 75, (n, width)), 0).astype(np.uint8)
    per_rank = mesh.spawn(torch_ranks.sharded_reports, 2, "cpu", str(tmp_path),
                          args=((seqs, quals, lengths),), timeout_s=120)
    for handed, report, spans in per_rank:
        assert handed == [None, {}]  # smooth_rank's report: none without `reports`
        assert sorted(report) == ["attempts", "rebalance_ms", "scatter_ms", "seg_scan_launches",
                                  "sent_bytes", "smooth_ms", "sort_ms", "staged_bytes"]
        assert all(isinstance(report[k], float) and report[k] > 0 for k in report if k.endswith("_ms"))
        # every span of the recorded call shares the root's call id
        roots = [s for s in spans if s["parent"] is None]
        assert [r["name"] for r in roots] == ["sharded.smooth_fastq"]
        assert all(s["call"] == roots[0]["id"] for s in spans)
        assert _children(spans)["sharded.smooth_fastq"] == [
            "sharded.pad", "sharded.upload", "sharded.sort", "sharded.rebalance", "sharded.smooth",
            "sharded.scatter", "sharded.gather"]


# ---- the benchmark's readers ----

def _s(name, i, parent=None, call=None, host_ms=0.0, self_ms=None, device_ms=None):
    return {"name": name, "id": i, "parent": parent, "call": call or i, "start_ns": i,
            "end_ns": i + 1, "host_ms": host_ms, "self_ms": host_ms if self_ms is None else self_ms,
            "device_ms": device_ms}


def _batch_spans():
    spans = []
    for c in (1, 100):  # two calls
        spans += [_s("engine.smooth_fastq", c, host_ms=1500.0, device_ms=1400.0),
                  _s("suffix.build_ebwt", c + 1, c, c, device_ms=550.0 + c),
                  _s("suffix.sort_lsd", c + 2, c + 1, c, device_ms=300.0 + c),
                  _s("smooth.smooth", c + 3, c, c, device_ms=430.0 + c),
                  _s("smooth.cluster_words", c + 4, c + 3, c, device_ms=250.0 + c),
                  _s("invert.invert_via_sa", c + 5, c, c, device_ms=40.0 + c)]
    return spans


def _file_spans():
    spans = []
    for c in (1, 100, 200):  # three files
        spans += [_s("cli.main", c, host_ms=4500.0, self_ms=90.0 + c),
                  _s("pipeline.fingerprint", c + 1, c, c, host_ms=150.0),
                  _s("pipeline.fingerprint", c + 2, c + 10, c, host_ms=160.0),
                  _s("pipeline.load_artifacts", c + 3, c, c, host_ms=200.0 + c),
                  _s("pipeline.format_fastq", c + 4, c, c, host_ms=1600.0 + c),
                  _s("pipeline.write", c + 5, c, c, host_ms=100.0),
                  _s("pipeline.write", c + 6, c, c, host_ms=300.0 + c)]
    return spans


def _mesh_spans():
    spans = []
    for c in (1, 100):  # two calls
        spans += [_s("sharded.smooth_fastq", c, host_ms=2000.0),
                  _s("sharded.pad", c + 1, c, c, host_ms=80.0),
                  _s("sharded.upload", c + 2, c, c, host_ms=120.0),
                  _s("sharded.sort", c + 3, c, c, device_ms=1000.0, host_ms=1000.0),
                  _s("sharded.gather", c + 4, c, c, host_ms=400.0 + c)]
    return spans


def _m3_spans():
    spans = []
    for c in (1, 100):  # two --m3 files
        spans += [_s("cli.main", c, host_ms=20000.0),
                  _s("pipeline.stream_split", c + 1, c, c, host_ms=90.0 + c),
                  _s("codec.compress", c + 2, c, c, host_ms=15000.0 + c),
                  _s("codec.stream", c + 3, c + 2, c, host_ms=14000.0),
                  _s("codec.rans", c + 4, c + 3, c, host_ms=1000.0),
                  _s("codec.cm", c + 5, c + 3, c, host_ms=12000.0 + c),
                  _s("codec.stream", c + 6, c + 2, c, host_ms=9000.0),
                  _s("codec.rans", c + 7, c + 6, c, host_ms=800.0 + c),
                  _s("codec.cm", c + 8, c + 6, c, host_ms=8000.0),
                  _s("codec.stream", c + 9, c + 2, c, host_ms=6000.0),
                  _s("headers.encode", c + 10, c + 9, c, host_ms=5900.0 + c),
                  _s("codec.rans", c + 11, c + 10, c, host_ms=100.0),
                  _s("codec.cm", c + 12, c + 10, c, host_ms=200.0)]
    return spans


READERS = {
    "suffix.build_span_ms": (_batch_spans, 550.0 + 50.5),
    "suffix.sort_span_ms": (_batch_spans, 300.0 + 50.5),
    "smooth.smooth_span_ms": (_batch_spans, 430.0 + 50.5),
    "smooth.cluster_words_span_ms": (_batch_spans, 250.0 + 50.5),
    "invert.invert_span_ms": (_batch_spans, 40.0 + 50.5),
    "pipeline.fingerprint_s": (_file_spans, 0.31),
    "pipeline.format_fastq_s": (_file_spans, (1600.0 + 301 / 3) / 1e3),
    "pipeline.write_s": (_file_spans, (400.0 + 301 / 3) / 1e3),
    "pipeline.load_artifacts_s": (_file_spans, (200.0 + 301 / 3) / 1e3),
    "pipeline.unspanned_s": (_file_spans, (90.0 + 301 / 3) / 1e3),
    "sharded.host_span_ms": (_mesh_spans, 80.0 + 120.0 + 400.0 + 50.5),
    "pipeline.stream_split_s": (_m3_spans, (90.0 + 50.5) / 1e3),
    "codec.compress_s": (_m3_spans, (15000.0 + 50.5) / 1e3),
    "codec.cm_s": (_m3_spans, (12000.0 + 8000.0 + 200.0 + 50.5) / 1e3),
    "codec.rans_s": (_m3_spans, (1000.0 + 800.0 + 100.0 + 50.5) / 1e3),
    "codec.headers_s": (_m3_spans, (5900.0 + 50.5) / 1e3),
}


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_on_hand_made_spans(name, monkeypatch):
    make, want = READERS[name]
    monkeypatch.setattr(profiling, "spans", make)
    assert _load("metrics", name).read({}) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_without_spans_reads_nothing(name, monkeypatch):
    reader = _load("metrics", name)
    monkeypatch.setattr(profiling, "spans", list)
    assert reader.read({}) is None
    monkeypatch.delattr(profiling, "spans")  # a program without spans
    assert reader.read({}) is None


@pytest.mark.parametrize("name", [n for n in sorted(READERS) if n.endswith("span_ms")
                                  and not n.startswith("sharded")])
def test_batch_reader_reads_nothing_without_device_times(name, monkeypatch):
    spans = [dict(s, device_ms=None) for s in _batch_spans()]
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    assert _load("metrics", name).read({}) is None


def test_span_cost_tool_on_the_cpu(capsys):
    """tools/span_cost_torch.py at a tiny size: both kinds of call timed in
    alternating pairs, with recording on and off."""
    spec = importlib.util.spec_from_file_location(
        "span_cost_torch", os.path.join(os.path.dirname(BENCH), "tools", "span_cost_torch.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.main(["--pairs", "2", "--reads", "400", "--file-reads", "300", "--cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"]["type"] == "cpu" and out["pairs"] == 2
    for kind, reads in (("batch", 400), ("file", 300)):
        got = out[kind]
        assert got["reads"] == reads and len(got["on_s"]) == len(got["off_s"]) == 2
        assert got["on"]["q1"] <= got["on"]["median"] <= got["on"]["q3"]
    assert profiling.spans() == []  # each "on" call's spans were read and forgotten


def _ext_spans():
    spans = []
    for c in (1, 100):  # two out-of-core files
        spans += [_s("cli.main", c, host_ms=60000.0),
                  _s("external.smooth_fastq", c + 1, c, c, host_ms=50000.0),
                  _s("external.sort_chunk", c + 2, c + 1, c, device_ms=4000.0 + c),
                  _s("external.sort_chunk", c + 3, c + 1, c, device_ms=2000.0),
                  _s("external.merge_wait", c + 4, c + 1, c, host_ms=3000.0 + c),
                  _s("external.segment", c + 5, c + 1, c, device_ms=1500.0),
                  _s("external.scatter", c + 6, c + 1, c, host_ms=2500.0 + c),
                  _s("external.segment", c + 7, c + 1, c, device_ms=900.0 + c),
                  _s("external.scatter", c + 8, c + 1, c, host_ms=1200.0),
                  _s("external.emit", c + 9, c + 1, c, host_ms=4000.0 + c)]
    return spans


EXT_READERS = {
    "external.sort_chunk_span_ms": 6000.0 + 50.5,
    "external.segment_span_ms": 2400.0 + 50.5,
    "external.merge_wait_s": (3000.0 + 50.5) / 1e3,
    "external.scatter_s": (3700.0 + 50.5) / 1e3,
    "external.emit_s": (4000.0 + 50.5) / 1e3,
}


@pytest.mark.parametrize("name", sorted(EXT_READERS))
def test_ext_reader_on_hand_made_spans(name, monkeypatch):
    monkeypatch.setattr(profiling, "spans", _ext_spans)
    assert _load("metrics", name).read({}) == pytest.approx(EXT_READERS[name])
    monkeypatch.setattr(profiling, "spans", list)
    assert _load("metrics", name).read({}) is None
    monkeypatch.delattr(profiling, "spans")  # a program without spans
    assert _load("metrics", name).read({}) is None


@pytest.mark.parametrize("name", [n for n in sorted(EXT_READERS) if n.endswith("span_ms")])
def test_ext_device_reader_reads_nothing_without_device_times(name, monkeypatch):
    spans = [dict(s, device_ms=None) for s in _ext_spans()]
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    assert _load("metrics", name).read({}) is None


def test_ext_merge_wait_reads_zero_when_the_merge_never_blocked(monkeypatch):
    spans = [s for s in _ext_spans() if s["name"] != "external.merge_wait"]
    monkeypatch.setattr(profiling, "spans", lambda: spans)
    assert _load("metrics", "external.merge_wait_s").read({}) == 0.0


def test_ext_peak_rss_reader():
    reader = _load("metrics", "external.peak_rss_gb")
    assert reader.read({"rss": {"start": 2_000_000_000, "peak": 5_500_000_000}}) == pytest.approx(3.5)
    assert reader.read({"rss": None}) is None and reader.read({}) is None


def test_codec_ratio_reader():
    """The last file's archive bytes from the program's counter over the
    input's bytes; nothing where the program kept no counter."""
    reader = _load("metrics", "codec.ratio")
    files = [{"seconds": 20.0, "archive_bytes": 10_000_000}, {"seconds": 19.0, "archive_bytes": 10_000_500}]
    assert reader.read({"files": files, "input_bytes": 140_000_000}) == pytest.approx(10_000_500 / 140e6)
    parent = [{"seconds": 20.0, "archive_bytes": None}]
    assert reader.read({"files": parent, "input_bytes": 140_000_000}) is None
    assert reader.read({}) is None

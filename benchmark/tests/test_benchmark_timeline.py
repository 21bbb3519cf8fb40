"""The trace arithmetic of timeline.py on a hand-made Chrome trace: the busy
union inside the marked span, the idle share, and copies between the host
and the card counted apart from copies within the card."""

import json

import pytest

from timeline import idle_pct, read_timeline


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


@pytest.fixture
def trace(tmp_path):
    events = [
        _x("user_annotation", "window", 100, 1000),
        _x("kernel", "void ns::scan_tiles<int>(int*)", 50, 100),  # clipped to [100, 150)
        _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 200, 100),
        _x("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 250, 100),  # overlaps the HtoD
        _x("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 600, 50),
        _x("gpu_memset", "Memset (Device)", 1090, 40),  # clipped to [1090, 1100)
        _x("kernel", "outside", 2000, 10),
        _x("cpu_op", "aten::copy_", 400, 150),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_busy_union_and_idle(trace):
    tl = read_timeline(trace, "window")
    assert tl["span_s"] == pytest.approx(1000e-6)
    assert tl["busy_s"] == pytest.approx((50 + 150 + 50 + 10) * 1e-6)
    assert tl["device_events"] == 5
    assert idle_pct({"timeline": tl}) == pytest.approx(74.0)
    assert dict(tl["idle_gaps"])["aten::copy_"] == pytest.approx(250e-6)  # the gap [350, 600)


def test_host_copies_apart_from_device_copies(trace):
    tl = read_timeline(trace, "window")
    assert tl["host_copy_count"] == 2
    assert tl["host_copy_s"] == pytest.approx(150e-6)
    assert tl["device_copy_s"] == pytest.approx(100e-6)
    assert dict(tl["device_ops"])["ns::scan_tiles"] == pytest.approx(50e-6)


def test_idle_reads_nothing_without_device_events(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [_x("user_annotation", "window", 0, 10)]}))
    assert idle_pct({"timeline": read_timeline(str(path), "window")}) is None

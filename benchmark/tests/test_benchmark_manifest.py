"""BENCHMARK.json against the contract's schema, and every file it names."""

import json
import os
import re

import pytest

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection", "head", "expansion")


@pytest.fixture(scope="module")
def manifest():
    path = os.path.join(ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    with open(path) as f:
        return json.load(f)


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level(manifest):
    assert set(manifest) == KEYS["top"]
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    cmd = manifest["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    files = [w for w in cmd if "/" in w]
    assert all(any(f.startswith(p + "/") for p in manifest["paths"]) for f in files)
    assert all(os.path.exists(os.path.join(ROOT, f)) for f in files)
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51


def test_check_fits_with_24_cells(manifest):
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (manifest["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_entries(manifest, kind):
    entries = manifest[kind]
    assert 1 <= len(entries) <= {"configs": 24, "workloads": 24, "end_to_end": 16, "per_layer": 128}[kind]
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
        assert KEYS[kind] <= set(e) <= KEYS[kind] | extra, e["name"]
        assert NAME.match(e["name"])
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
    if kind == "end_to_end":
        assert "setup_s" in names
        for e in entries:
            assert e["source"] in ("host_clock", "device_trace")
            assert 0.01 <= e["bound"] <= 0.25
    if kind == "per_layer":
        e2e = {m["name"] for m in manifest["end_to_end"]}
        for e in entries:
            assert _line(e["layer"]) and e["moves"] in e2e
            if e["unit"] == "%" and "roofline" in e["name"]:
                assert e["name"].endswith("_roofline")


def test_configs(manifest):
    used = {c["config"] for c in manifest["workloads"]}
    for c in manifest["configs"]:
        assert c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in manifest["paths"])
        with open(os.path.join(ROOT, c["file"])) as f:
            data = json.load(f)
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert len(c["reduced"]) <= 16 and set(c["reduced"]) == set(data["reduced"])
        for key in c["reduced"]:
            assert NAME.match(key)
            assert not key.endswith(("_dim", "_rank")) and not any(w in key for w in WIDTH_WORDS)
    files = [c["file"] for c in manifest["configs"]]
    assert len(set(files)) == len(files)


def test_cells(manifest):
    cells = manifest["workloads"]
    four = sum(c["chips"] == 4 for c in cells)
    assert four <= max(1, len(cells) // 4)
    pairs = [(c["config"], c["traffic"]) for c in cells]
    assert len(set(pairs)) == len(pairs)
    configs = {c["name"] for c in manifest["configs"]}
    for c in cells:
        assert c["chips"] in (1, 4) and c["config"] in configs and _line(c["why"])
        names = lambda kind: [m["name"] for m in manifest[kind] if c["name"] in m.get("workloads", [c["name"]])]
        e2e, layer = names("end_to_end"), names("per_layer")
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        for m in manifest["per_layer"]:
            if c["name"] in m.get("workloads", []):
                assert m["moves"] in e2e, (m["name"], c["name"])
    for kind in ("end_to_end", "per_layer"):
        for m in manifest[kind]:
            assert set(m.get("workloads", [])) <= {c["name"] for c in cells}
    for m in manifest["per_layer"]:
        assert "workloads" in m, m["name"]


def test_files_found_by_name(manifest):
    for c in manifest["workloads"]:
        with open(os.path.join(BENCH, "workloads", c["traffic"] + ".json")) as f:
            traffic = json.load(f)
        assert traffic["name"] == c["name"] and traffic["config"] == c["config"]
        assert traffic["why"] == c["why"]
        assert os.path.exists(os.path.join(BENCH, "entries", traffic["entry"] + ".py"))
        assert traffic["rate_metric"] in {m["name"] for m in manifest["end_to_end"]}
    for m in manifest["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics", m["name"] + ".py")), m["name"]


def test_file_names_are_names(manifest):
    for p in manifest["paths"]:
        for dirpath, dirnames, filenames in os.walk(os.path.join(ROOT, p)):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for name in dirnames + filenames:
                assert NAME.match(name), os.path.join(dirpath, name)

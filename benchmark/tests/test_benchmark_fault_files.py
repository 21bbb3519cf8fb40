"""Each one-chip cell's entry owns its fault plants (tests/faults/<entry>.py),
and the test-only size overrides of harness.load_cell leave a real run's
configuration and traffic as the files give them."""

import json
import os

import pytest

from conftest import FAULT_KINDS, ROOT, fault_file
import harness

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    MANIFEST = json.load(f)
CELLS = [c["name"] for c in MANIFEST["workloads"]]
ONE_CHIP = [c["name"] for c in MANIFEST["workloads"] if c["chips"] == 1]


def _files(cell):
    """The configuration and traffic of `cell` as their files hold them."""
    traffic = harness.load_json(harness.HERE, "workloads", cell + ".json")
    return harness.load_json(harness.HERE, "configs", traffic["config"] + ".json"), traffic


@pytest.mark.parametrize("cell", ONE_CHIP)
def test_every_one_chip_entry_has_its_faults(cell):
    module = fault_file(_files(cell)[1]["entry"])
    assert sorted(module.FAULTS) == sorted(FAULT_KINDS)
    assert all(callable(plant) for plant in module.FAULTS.values())
    assert isinstance(module.SIZE, dict) and module.SIZE


def test_traffic_override_merges_and_reads_stay():
    cell = "hiseq101.file"
    _, want = _files(cell)
    _, config, traffic, _ = harness.load_cell(cell, MANIFEST, {"count": 300})
    extra = {"cli_args": ["-0", "--mem", "64"], "max_calls": 2}
    _, config_t, traffic_t, entry = harness.load_cell(
        cell, MANIFEST, {"count": 300, "traffic": extra})
    assert traffic_t == dict(traffic, **extra)
    assert traffic_t["reads"] == dict(want["reads"], count=300)
    assert config_t == config and config_t["reads"]["count"] == 300
    assert entry.__name__.endswith("cli_file")

    # a traffic without reads of its own gets none from the overrides
    _, config_b, traffic_b, _ = harness.load_cell(
        "hiseq101.batch", MANIFEST, {"count": 300, "traffic": {"warmup_calls": 0}})
    assert "reads" not in traffic_b and traffic_b["warmup_calls"] == 0
    assert config_b["reads"]["count"] == 300


@pytest.mark.parametrize("cell", CELLS)
def test_no_overrides_leaves_the_files_as_they_are(cell):
    config, traffic = _files(cell)
    for overrides in (None, {}):
        got_cell, got_config, got_traffic, _ = harness.load_cell(cell, MANIFEST, overrides)
        assert got_cell == harness.cell_of(MANIFEST, cell)
        assert got_config == config and got_traffic == traffic

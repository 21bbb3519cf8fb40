"""A short run of every cell on the card, as `benchmark/run.py` makes it:
correct, the cell's end-to-end metrics, the device named; and a traced run
whose per-layer metrics are all read."""

import json
import os

import pytest

from conftest import ROOT
from harness import metrics_of, run_cell

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    MANIFEST = json.load(f)
CELLS = [c["name"] for c in MANIFEST["workloads"]]
CHIPS = {c["name"]: c["chips"] for c in MANIFEST["workloads"]}


@pytest.mark.card
@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell, trace):
    import torch

    if torch.cuda.device_count() < CHIPS[cell]:
        pytest.skip(f"{cell} needs {CHIPS[cell]} cards")
    r = run_cell(cell, 2**31 + 5, 3.0, trace=trace)
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert r["device"]["kind"] == torch.cuda.get_device_name(0)
    kind = "per_layer" if trace else "end_to_end"
    assert set(r["metrics"]) == {m["name"] for m in metrics_of(MANIFEST, cell, kind)}
    if trace:
        assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]

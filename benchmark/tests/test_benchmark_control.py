"""The control of `correct`: the program with its Illumina 8-level quality
binning switched on (qualities below the configuration's precision) must
come out not correct, and the program as configured correct, at a size a
test run holds, on the CPU.  On the card the same readings are taken at each
cell's own size by `benchmark/control.py`."""

import json
import os

import pytest

import control
from conftest import ROOT

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    CHIPS = {c["name"]: c["chips"] for c in json.load(f)["workloads"]}
CELLS = sorted(CHIPS)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_sound_passes(cell):
    sound, ctrl = control.readings(cell, 2**31 + 99, device="cpu", overrides={"count": 600})
    assert sound["kind"] == "sound" and sound["correct"], sound
    assert ctrl["kind"] == "control" and not ctrl["correct"], ctrl
    assert max(ctrl["checks"].values()) > 1000


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(card, cell):
    import torch

    if torch.cuda.device_count() < CHIPS[cell]:
        pytest.skip(f"{cell} needs {CHIPS[cell]} cards")
    sound, ctrl = control.readings(cell, 2**31 + 7, device="cuda")
    assert sound["correct"] and not ctrl["correct"]

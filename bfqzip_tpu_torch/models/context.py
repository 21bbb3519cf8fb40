"""Context models for the rANS entropy coder (the port's copy of
bfqzip_tpu/models/context.py).

The reference's step 5 shells out to PPMd and libbsc (BFQzip.py:253-275) —
adaptive context modeling inside black-box binaries.  Here the model is
explicit and static (two-pass): a context function maps each position's
recent history to a context id, frequencies are histogrammed per context,
and the rANS coder conditions on them.  Static tables keep decode vectorised
across interleaved lanes (an adaptive model would serialise it).

Data is striped into LANES contiguous chunks; contexts reset at chunk starts
(history = 0), so both encode and decode stay lane-local.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ContextSpec:
    """order: how many previous (dense) symbols form the context."""

    spec_id: int
    order: int

    def num_contexts(self, k: int) -> int:
        return k**self.order if self.order else 1

    def contexts(self, rows: np.ndarray, k: int) -> np.ndarray:
        """ctx id per position for [lanes, chunk] dense-symbol rows; history
        before each row start is all-zeros."""
        lanes, chunk = rows.shape
        ctx = np.zeros((lanes, chunk), dtype=np.int64)
        mult = 1
        for o in range(1, self.order + 1):
            prev = np.zeros_like(rows)
            if chunk > o:
                prev[:, o:] = rows[:, :-o]
            ctx += prev.astype(np.int64) * mult
            mult *= k
        return ctx


Order0Spec = ContextSpec(spec_id=0, order=0)
Order1Spec = ContextSpec(spec_id=1, order=1)
Order2Spec = ContextSpec(spec_id=2, order=2)

_SPECS = {s.spec_id: s for s in (Order0Spec, Order1Spec, Order2Spec)}


def spec_by_id(spec_id: int) -> ContextSpec:
    return _SPECS[spec_id]

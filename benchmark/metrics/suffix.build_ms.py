"""suffix.build_ms: milliseconds of ops/suffix.build_ebwt on the cell's batch.

Source: the traced run's stage pass, after the window, on the same reads as
device tensors: build_ebwt, smooth(pre=pre_of(..)) and invert_via_sa, the
calls engine.smooth_step makes, each ended by a synchronise; the median of
the passes."""


def read(rec):
    stages = rec.get("stages_ms")
    if not stages or "build" not in stages:
        return None
    return stages["build"]

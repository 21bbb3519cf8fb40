"""smooth.smooth_ms: milliseconds of ops/smooth.smooth (with engine.pre_of) on the cell's batch.

Source: the traced run's stage pass, after the window, on the same reads as
device tensors: build_ebwt, smooth(pre=pre_of(..)) and invert_via_sa, the
calls engine.smooth_step makes, each ended by a synchronise; the median of
the passes."""


def read(rec):
    stages = rec.get("stages_ms")
    if not stages or "smooth" not in stages:
        return None
    return stages["smooth"]

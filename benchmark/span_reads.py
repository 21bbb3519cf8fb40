"""The program's spans, as the per-layer metrics of `source: program_span` read them.

bfqzip_tpu_torch.utils.profiling records a span at each of the program's
layer boundaries while a torch.profiler is active.  The harness profiles
the window in its own process (rank 0 in the mesh cell), so after a traced
run that process holds the window's spans, and nothing from set-up or from
the readings after the window.  A checkout of the program without spans
gives every reader nothing (None)."""

from __future__ import annotations


def recorded() -> list:
    """The spans this process recorded, as dicts (`profiling.spans()`), or []
    where the program has no `profiling.spans`: these readers also run over
    older checkouts of the program, when a commit from before the spans is
    measured against the benchmark as it stands, and must not raise there."""
    from bfqzip_tpu_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    return read() if read is not None else []


def per_call(names, field: str, calls: str):
    """The sum of `field` ("device_ms", "host_ms" or "self_ms") over the
    spans named in `names`, over the number of spans named `calls`; None
    where either is absent or a span has no such number (device_ms without
    a card)."""
    spans = recorded()
    got = [s[field] for s in spans if s["name"] in names]
    n_calls = sum(s["name"] == calls for s in spans)
    if not got or not n_calls or any(v is None for v in got):
        return None
    return sum(got) / n_calls

"""Device time inside a marked host span of a torch.profiler Chrome trace.

The arithmetic of the program's `utils/profiling.device_timeline`, kept here
so the yardstick stays fixed: the card is busy where a kernel, copy or fill
runs, overlaps merged, clipped to the span of the user annotation; the rest
of the span is idle.  Copies between the host and the card (HtoD, DtoH) are
also summed apart from the card's own copies (DtoD, PtoP).  Each idle gap is named by the innermost host event that
covers its middle (torch ops and annotations; "host, no torch op" where none
does).
"""

from __future__ import annotations

import json

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_COPY_KINDS = ("HtoD", "DtoH")  # in a gpu_memcpy event's name: "Memcpy HtoD (Pageable -> Device)"
HOST_CATEGORIES = ("cpu_op", "user_annotation", "python_function")
TOP = 10


def short_name(name: str) -> str:
    """A device operation's name without its return type, template and
    argument lists ('void ns::kernel<...>(...)' -> 'ns::kernel')."""
    name = name.removeprefix("void ")
    cut = [i for i in (name.find("<"), name.find("(")) if i > 0]
    return (name[: min(cut)] if cut else name).strip()


def _merge(intervals: list) -> list:
    """The union of [start, end) intervals, as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read_timeline(path: str, region: str) -> dict:
    """span_s, busy_s; per device operation its count and seconds (`ops`),
    the top ones, kernels by short name (`device_ops`); the longest
    idle gaps by what the host was doing (`idle_gaps`); seconds and count of
    copies between the host and the card (`host_copy_s`, `host_copy_count`)
    and of copies within the card (`device_copy_s`)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e.get("name") == region]
    if len(spans) != 1:
        raise ValueError(f"{len(spans)} host spans named {region!r} in the trace")
    t0 = float(spans[0]["ts"])
    t1 = t0 + float(spans[0]["dur"])
    clipped, ops = [], {}
    host_copy_us, host_copy_count, device_copy_us = 0.0, 0, 0.0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
            continue
        s = max(float(e["ts"]), t0)
        end = min(float(e["ts"]) + float(e["dur"]), t1)
        if end <= s:
            continue
        clipped.append((s, end))
        op = ops.setdefault(e["name"], {"count": 0, "s": 0.0, "cat": e["cat"]})
        op["count"] += 1
        op["s"] += (end - s) / 1e6
        if e["cat"] == "gpu_memcpy":
            if any(kind in e["name"] for kind in HOST_COPY_KINDS):
                host_copy_us += end - s
                host_copy_count += 1
            else:
                device_copy_us += end - s
    busy = _merge(clipped)
    busy_s = sum(e - s for s, e in busy) / 1e6
    gaps, cursor = [], t0
    for s, e in busy + [[t1, t1]]:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
            if e.get("ph") == "X" and e.get("cat") in HOST_CATEGORIES and e.get("name") != region]
    idle = {}
    for gs, ge in gaps:
        mid = (gs + ge) / 2
        inner = [(he - hs, hname) for hs, he, hname in host if hs <= mid <= he]
        best = min(inner)[1] if inner else "host, no torch op"
        idle[best] = idle.get(best, 0.0) + (ge - gs) / 1e6
    by_short = {}
    for k, v in ops.items():
        key = short_name(k) if v["cat"] == "kernel" else k
        by_short[key] = by_short.get(key, 0.0) + v["s"]
    top_ops = sorted(by_short.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "span_s": (t1 - t0) / 1e6,
        "busy_s": busy_s,
        "ops": ops,
        "device_ops": [[k, s] for k, s in top_ops],
        "idle_gaps": sorted(([k, v] for k, v in idle.items()), key=lambda kv: -kv[1])[:TOP],
        "host_copy_s": host_copy_us / 1e6,
        "host_copy_count": host_copy_count,
        "device_copy_s": device_copy_us / 1e6,
        "device_events": len(clipped),
    }


def idle_pct(rec: dict):
    """The share of the traced window in which the card ran nothing:
    100 * (1 - busy / span); None where the window holds no device event."""
    tl = rec.get("timeline")
    if not tl or not tl["device_events"]:
        return None
    return 100.0 * (1.0 - tl["busy_s"] / tl["span_s"])

"""Profiling / observability of the port.

Port of bfqzip_tpu/utils/profiling.py.  The reference instruments itself
with malloc interposition (per-phase peak heap via malloc_count,
bfq_int.cpp:976-1001) and wall-clock timers around every step
(BFQzip.py:98-145).  The port's equivalents:

  * phase timers on the host clock, synchronised with the card before each
    read, so that the kernels a phase queued count in that phase;
  * device memory statistics per phase (torch.cuda's allocator counters,
    the analog of malloc_count_peak_curr);
  * torch.profiler traces (CPU activity, plus CUDA on a card), kept for
    key_averages() and written as a Chrome trace, and `device_timeline`,
    which reads a written trace: device-busy time with overlaps merged, the
    idle share of a marked region, and time per device kernel.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, List, Optional

import torch

from bfqzip_tpu_torch.engine import resolve_device

# Chrome-trace categories of work on the card: kernels, copies and fills
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def device_memory_stats(device="cuda") -> Dict[str, int]:
    """Bytes in use / peak / capacity of a CUDA device, with the JAX
    package's keys; {} for the CPU.  "cuda" without a card raises."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {}
    return {
        "bytes_in_use": torch.cuda.memory_allocated(dev),
        "peak_bytes_in_use": torch.cuda.max_memory_allocated(dev),
        "bytes_limit": torch.cuda.get_device_properties(dev).total_memory,
    }


class PhaseProfiler:
    """Collects (phase, wall seconds, device-memory snapshot) records, and
    traces regions with torch.profiler."""

    def __init__(self, trace_dir: Optional[str] = None, device="cuda"):
        self.records: List[dict] = []
        self.trace_dir = trace_dir
        self.device = resolve_device(device)
        self.profile: Optional[torch.profiler.profile] = None  # the last trace()'s
        self.trace_path: Optional[str] = None  # the last Chrome trace written

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            rec = {"phase": name, "seconds": time.perf_counter() - t0}
            rec.update(device_memory_stats(self.device))
            self.records.append(rec)

    @contextlib.contextmanager
    def trace(self, region: str = "traced"):
        """Profile the region (CPU activity, plus CUDA on a CUDA device),
        marked as a user annotation named `region`, with the card idle at
        both ends.  The profile stays in `self.profile`; with a trace_dir,
        its Chrome trace is written there and its path kept in
        `self.trace_path`."""
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        self._sync()
        with torch.profiler.profile(activities=activities) as prof:
            with torch.profiler.record_function(region):
                yield prof
                self._sync()
        self.profile = prof
        if self.trace_dir:
            os.makedirs(self.trace_dir, exist_ok=True)
            self.trace_path = os.path.join(self.trace_dir, f"{region}.trace.json")
            prof.export_chrome_trace(self.trace_path)

    def report(self) -> str:
        lines = []
        for r in self.records:
            mem = ""
            if "peak_bytes_in_use" in r:
                mem = f"  peak_dev_mem={r['peak_bytes_in_use']/2**20:.1f}MB"
            lines.append(f"{r['phase']}: {r['seconds']:.3f}s{mem}")
        return "\n".join(lines)


def _merged_us(intervals) -> float:
    """Total length of the union of [start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def device_timeline(trace_path: str, region: str) -> dict:
    """The card's work inside the host span of user annotation `region` of
    a Chrome trace written by PhaseProfiler.trace.

    busy_ms is the union of every kernel, copy and fill interval, clipped to
    the span, overlaps merged; idle_share = 1 - busy_ms / span_ms.  kernels
    maps each kernel name to its launches and summed ms (None for a trace
    that holds no device event: a CPU run has no device timeline, and so
    no idle share)."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e.get("name") == region]
    if len(spans) != 1:
        raise ValueError(f"{len(spans)} host spans named {region!r} in {trace_path}")
    t0 = float(spans[0]["ts"])
    t1 = t0 + float(spans[0]["dur"])
    device = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]
    span_ms = (t1 - t0) / 1e3
    if not device:
        return {"span_ms": span_ms, "busy_ms": None, "idle_share": None, "kernels": None}
    clipped, kernels = [], {}
    for e in device:
        s, d = float(e["ts"]), float(e["dur"])
        s, end = max(s, t0), min(s + d, t1)
        if end <= s:
            continue
        clipped.append((s, end))
        if e["cat"] == "kernel":
            k = kernels.setdefault(e["name"], {"launches": 0, "ms": 0.0})
            k["launches"] += 1
            k["ms"] += (end - s) / 1e3
    busy_ms = _merged_us(clipped) / 1e3
    return {"span_ms": span_ms, "busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / span_ms,
            "kernels": kernels}

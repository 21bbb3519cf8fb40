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
    idle share of a marked region, and time per device kernel;
  * `best_ms`, the best of a few timed calls after a warm-up (CUDA events
    on a card), `device_info`, the card's name, count and power limit
    that every measurement is printed beside, `host_info`, the host's CPU
    model and cores beside host-side measurements, and `RssSampler`, the
    peak resident set of a stretch of work;
  * spans at the program's layer boundaries (`span`, read back by `spans`),
    recorded while a torch.profiler is active or inside `recording()`.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import platform
import subprocess
import threading
import time
from typing import Callable, Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler


def resolve_device(device) -> torch.device:
    """The device asked for; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False")
    return dev


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


def device_info(device="cuda") -> dict:
    """The device's type and name, the number of cards, and a card's power
    limit as `nvidia-smi --query-gpu=name,power.limit` reports it (None on
    the CPU).  "cuda" without a card raises."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {"type": dev.type, "name": dev.type, "count": torch.cuda.device_count(),
                "power_limit": None}
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", str(index)],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return {"type": "cuda", "name": torch.cuda.get_device_name(dev), "count": torch.cuda.device_count(),
            "power_limit": smi.rsplit(",", 1)[-1].strip()}


def host_info() -> dict:
    """The host's CPU model, its core count and the cores this process may
    use, which host-side measurements are printed beside.  The model is
    /proc/cpuinfo's "model name", or its vendor, family and model numbers
    where a virtual machine reports the name as unknown, or
    platform.processor() without /proc/cpuinfo."""
    info = {}
    if os.path.exists("/proc/cpuinfo"):
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break  # the first processor's fields
                key, _, value = line.partition(":")
                info[key.strip()] = value.strip()
    model = info.get("model name")
    if model in (None, "", "unknown") and "cpu family" in info:
        model = f"{info.get('vendor_id', '')} family {info['cpu family']} model {info.get('model')}".strip()
    return {"cpu_model": model or platform.processor() or None, "cpu_count": os.cpu_count(),
            "affinity": len(os.sched_getaffinity(0))}


class RssSampler:
    """The process's resident set (/proc/self/statm) sampled every 50 ms on a
    thread: `start` on entry, `peak` of the samples and the exit reading.
    getrusage's ru_maxrss is the peak since the process began, and a process
    started by fork and exec carries its parent's over (on some kernels
    /proc's VmHWM does too), so a stretch of work, or a tool started by a
    large parent, reads its own peak only this way.  A spike shorter than
    the period can be missed."""

    def __init__(self):
        self.peak = self.start = self.rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    @staticmethod
    def rss() -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")

    def _run(self):
        while not self._stop.wait(0.05):
            self.peak = max(self.peak, self.rss())

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self.rss())
        return False


def best_ms(fn: Callable[[], object], device="cuda", reps: int = 3) -> float:
    """The fastest of `reps` calls of fn after one warm-up call, in ms: CUDA
    events around each call on a card, the host clock on the CPU."""
    dev = resolve_device(device)
    fn()
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
    return min(times)


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


# ---- spans ----
#
# A span is one interval of the program at a layer boundary: its name, its
# host start and end, its parent span and its call (the outermost span of
# the thread's stack, or of the parent given to a span opened on another
# thread), and on CUDA a pair of timing events on the current stream, read
# only when the spans are read.  Each span also opens the
# torch.profiler annotation "bfq.<name>", so it lands in a device trace.
# The host times are time.time_ns(), the clock (Unix time) the profiler
# converts its own to: the start is the midpoint of the stamps around the
# annotation's opening call, the end a stamp after its closing call, so
# each agrees with the annotation's to some tens of microseconds.
# Recording is on while a torch.profiler is active or inside recording();
# otherwise span() is one flag test and a shared null context.

_recording = 0  # depth of recording() blocks
_records: list = []  # finished spans, kept in memory until clear_spans()
_ids = itertools.count(1)
_local = threading.local()  # each thread's stack of open spans
_NULL = contextlib.nullcontext()


class _Span:
    """One span.  `kept` spans are recorded (annotation, stack, records);
    a span that is only timed (span(timed=True) with recording off) has the
    host times and the events alone."""

    __slots__ = ("name", "kept", "id", "parent", "call", "start_ns", "end_ns", "_above", "_rf",
                 "_events", "_device_ms")

    def __init__(self, name: str, kept: bool, above: Optional["_Span"] = None):
        self.name, self.kept, self._above = name, kept, above
        self.id = self.parent = self.call = self._rf = self._events = self._device_ms = None

    def __enter__(self):
        if self.kept:
            stack = _stack()
            self.id = next(_ids)
            above = self._above if self._above is not None else (stack[-1] if stack else None)
            if above is not None:
                self.parent, self.call = above.id, above.call
            else:
                self.call = self.id
            stack.append(self)
            self._rf = torch.profiler.record_function("bfq." + self.name)
        self.start_ns = time.time_ns()
        if self._rf is not None:
            self._rf.__enter__()
            self.start_ns = (self.start_ns + time.time_ns()) // 2
        if torch.cuda.is_initialized():
            self._events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[1].record()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        self.end_ns = time.time_ns()
        if self.kept:
            _stack().pop()
            _records.append(self)
        return False

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    @property
    def device_ms(self) -> Optional[float]:
        """Milliseconds between the span's two events on the card (None
        without a card); waits for the closing event if it has not run."""
        if self._device_ms is None and self._events is not None:
            self._events[1].synchronize()
            self._device_ms = self._events[0].elapsed_time(self._events[1])
            self._events = None
        return self._device_ms

    @property
    def ms(self) -> float:
        """device_ms where there is one, else host_ms."""
        device = self.device_ms
        return self.host_ms if device is None else device


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, timed: bool = False, parent: Optional[_Span] = None):
    """Context manager: the span `name` of the code inside it, recorded while
    recording is on (it yields the span).  Off, it yields None, unless
    `timed`: then it yields a span that keeps its times (`ms`) for the
    caller alone, and opens no annotation and records nothing.

    `parent`, a span another thread yielded (None: this thread's innermost
    open span), gives a span opened on a worker thread its parent and call;
    the spans opened inside it on that thread nest under it as usual."""
    if _recording or _autograd_profiler._is_profiler_enabled:
        return _Span(name, True, parent)
    return _Span(name, False) if timed else _NULL


def current_span() -> Optional[_Span]:
    """This thread's innermost recorded open span, or None: the `parent` to
    hand to a span that a worker thread opens for it."""
    stack = _stack()
    return stack[-1] if stack else None


@contextlib.contextmanager
def recording():
    """Record spans inside this block, with or without a torch.profiler."""
    global _recording
    _recording += 1
    try:
        yield
    finally:
        _recording -= 1


def spans() -> List[dict]:
    """The recorded spans in start order, as dicts: name, id, parent (id or
    None), call (the outermost span's id), start_ns / end_ns (time.time_ns
    clock), host_ms, self_ms (host_ms minus the union of its children's
    intervals, so that children running at once on several threads count
    once) and device_ms (None without a card).  A child opens and closes
    inside its parent: on the parent's thread, or on a worker thread that
    was handed the parent (span(parent=...)) and joined before it closes."""
    done = sorted(_records, key=lambda s: s.start_ns)
    children: Dict[int, list] = {}
    for s in done:
        if s.parent is not None:
            children.setdefault(s.parent, []).append((s.start_ns, s.end_ns))
    return [{"name": s.name, "id": s.id, "parent": s.parent, "call": s.call,
             "start_ns": s.start_ns, "end_ns": s.end_ns, "host_ms": s.host_ms,
             "self_ms": s.host_ms - _merged_us(children.get(s.id, ())) / 1e6,
             "device_ms": s.device_ms} for s in done]


def clear_spans() -> None:
    """Forget the recorded spans."""
    _records.clear()

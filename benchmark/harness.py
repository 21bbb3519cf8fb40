"""The benchmark's driver: one cell, one seed, one measured window, one result line.

A cell (`BENCHMARK.json` `workloads`) names a configuration
(`configs/<config>.json`) and a traffic mix (`workloads/<cell>.json`); the
traffic names the entry (`entries/<entry>.py`) that the window drives.  The
harness finds each file by that name, so a new cell, configuration, entry or
per-layer metric is a new file and a new line of `BENCHMARK.json`.

An entry module provides:

    setup(ctx) -> state       make the inputs from ctx.seed, warm every shape up
    call(state) -> (units, output)   one closed-loop call, finished on return
    discard(state, output)    drop an output that is not kept for the check
    release(state)            free the program's state on the device
    check(state, output) -> {name: (value, limit)}   the reference's verdict
    close(state)              stop whatever the entry started
and optionally
    begin_window(state, trace), end_window(state, trace)   around the window
    peak_bytes(state) -> int  device peaks the harness cannot read itself (the
                              program's resets, other ranks' cards)
    traced(state) -> dict     records of the traced run (a stage pass, reports;
                              `busy_share_ranks`, each card's busy share)
    forbidden_modules(state) -> list   what the entry's other processes hold of
                              FORBIDDEN, each named with its process
    control(state)            switch on the control of `correct` (control.py)

The window issues calls until `--seconds` have passed (or the traffic's
`max_calls` are done); the call running at the end finishes and counts, and
a rate is all the calls' units over the time from the window's start to the
end of the last call.  One call's output, drawn from the seed, is kept and
checked against the reference once the window has closed, the device peak
has been read and the program's state is freed.  Only then, as the run's
last step, `sys.modules` of this process and of the entry's others is
searched for JAX and the JAX package (`run.py` searches its own again just
before it prints).
"""

from __future__ import annotations

import contextlib
import glob
import importlib.util
import json
import os
import random
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "bfqzip_tpu")


class Refused(Exception):
    """The run cannot be made here (no card, too few cards, a bad cell)."""


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """benchmark/<kind>/<name>.py as a module."""
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.exists(path):
        raise Refused(f"no {kind} file {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}".replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_of(manifest: dict, name: str) -> dict:
    for cell in manifest["workloads"]:
        if cell["name"] == name:
            return cell
    raise Refused(f"no workload {name!r} in BENCHMARK.json")


def metrics_of(manifest: dict, cell: str, kind: str) -> list:
    """The cell's metrics of one kind: those that list it, or list no cells."""
    return [m for m in manifest[kind] if cell in m.get("workloads", [cell])]


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc clock ticks)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start


class Context:
    """What an entry is given: the cell, its configuration and traffic, the
    seed, the device, and a scratch directory under TMPDIR."""

    def __init__(self, cell: dict, config: dict, traffic: dict, seed: int, device: str,
                 scratch: str):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.device, self.scratch = seed, device, scratch


def use_checkout_caches() -> None:
    """Point the kernel and build caches at fixed paths inside the checkout
    (the program's own nvcc cache, build/bfqzip_tpu_torch/, is there too).
    Call before torch is imported."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(ROOT, "build", "benchmark", sub)
    os.environ["USE_FLAX"] = "0"


def load_cell(name: str, manifest: dict, overrides: dict | None = None) -> tuple:
    """(cell, config, traffic, entry module) of cell `name`; `overrides` are
    merged into the reads of the configuration and of the traffic."""
    cell = cell_of(manifest, name)
    config = load_json(HERE, "configs", cell["config"] + ".json")
    traffic = load_json(HERE, "workloads", name + ".json")
    if traffic["config"] != cell["config"]:
        raise Refused(f"workloads/{name}.json names {traffic['config']}, BENCHMARK.json {cell['config']}")
    if overrides:
        config = dict(config, reads=dict(config["reads"], **overrides))
        if "reads" in traffic:
            traffic = dict(traffic, reads=dict(traffic["reads"], **overrides))
    return cell, config, traffic, load_module("entries", traffic["entry"])


def forbidden_modules() -> list:
    """Top-level names of FORBIDDEN in this process's sys.modules, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def built_libraries() -> set:
    """The program's compiled libraries in the checkout: the CUDA and C++
    builds of bfqzip_tpu_torch and the native codecs.  One that appears
    during a run was built by it (a checkout's first run: `cold_build`)."""
    return set(glob.glob(os.path.join(ROOT, "build", "bfqzip_tpu_torch", "*.so"))
               + glob.glob(os.path.join(ROOT, "native", "*.so")))


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             overrides: dict | None = None, manifest: dict | None = None) -> dict:
    """One run of cell `name`; returns the result line as a dict.

    `device` and `overrides` (merged into the configuration's `reads`) exist
    for the harness's own tests, which drive a run on the CPU at a small size.
    """
    import torch

    manifest = manifest or load_json(ROOT, "BENCHMARK.json")
    cell = cell_of(manifest, name)
    if device == "cuda":
        if not torch.cuda.is_available():
            raise Refused("torch.cuda.is_available() is False: the benchmark runs on the card only")
        if torch.cuda.device_count() < cell["chips"]:
            raise Refused(f"the cell needs {cell['chips']} cards, "
                          f"torch.cuda.device_count() is {torch.cuda.device_count()}")
    cell, config, traffic, entry = load_cell(name, manifest, overrides)
    cuda = device == "cuda"
    libraries = built_libraries()

    with tempfile.TemporaryDirectory(prefix="bench-") as scratch:
        ctx = Context(cell, config, traffic, seed, device, scratch)
        state = entry.setup(ctx)
        try:
            return _measure(entry, state, ctx, manifest, seconds, trace, cuda, libraries)
        finally:
            entry.close(state)


def _measure(entry, state, ctx, manifest, seconds, trace, cuda, libraries) -> dict:
    import torch

    name = ctx.cell["name"]
    max_calls = ctx.traffic.get("max_calls")
    pick = random.Random(ctx.seed)
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    profiler = _Profiler(ctx.scratch) if trace else None
    if hasattr(entry, "begin_window"):
        entry.begin_window(state, trace)

    setup_s = process_age_s()
    kept, calls, units, failed = None, 0, 0, 0
    ends = []
    with profiler or contextlib.nullcontext():
        t0 = time.perf_counter()
        while True:
            try:
                u, out = entry.call(state)
            except Exception:  # a call that fails ends the window and the run's correctness
                traceback.print_exc(file=sys.stderr)
                t_end = time.perf_counter()
                calls += 1
                failed += 1
                break
            t_end = time.perf_counter()
            ends.append(t_end - t0)
            calls += 1
            units += u
            # reservoir of one: every call is the kept one with chance 1/calls
            if kept is None or pick.random() < 1.0 / calls:
                if kept is not None:
                    entry.discard(state, kept)
                kept = out
            else:
                entry.discard(state, out)
            if t_end - t0 >= seconds or (max_calls and calls >= max_calls):
                break
    window_s = t_end - t0
    if hasattr(entry, "end_window"):
        entry.end_window(state, trace)

    peak = 0
    if cuda:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    if hasattr(entry, "peak_bytes"):
        peak = max(peak, entry.peak_bytes(state))
    call_s = [b - a for a, b in zip([0.0] + ends, ends)]
    print(f"benchmark: call seconds {' '.join(f'{c:.4f}' for c in call_s)}", file=sys.stderr)

    records = {"calls": calls, "units": units, "window_s": window_s, "config": ctx.config,
               "traffic": ctx.traffic, "cell": ctx.cell}
    timeline = None
    if profiler is not None:
        timeline = profiler.timeline()
        records["timeline"] = timeline
        if hasattr(entry, "traced"):
            records.update(entry.traced(state))

    entry.release(state)
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = {"failed_calls": (failed, 0)}
    if kept is not None:
        checks.update(entry.check(state, kept))
    print(f"benchmark: the reference check took {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)
    correct = all(value <= limit for value, limit in checks.values())

    if trace:
        metrics = {}
        for m in metrics_of(manifest, name, "per_layer"):
            value = load_module("metrics", m["name"]).read(records)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {
            "setup_s": setup_s,
            "peak_device_GB": peak / 1e9,
            ctx.traffic["rate_metric"]: units / window_s,
        }
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in metrics_of(manifest, name, "end_to_end") if m["name"] in e2e}

    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": ctx.cell["chips"] if cuda else 0,
              "memory_peak_bytes": max(peak, setup_peak) if cuda else 0}
    result = {"correct": correct, "attempted": calls, "failed": failed + int(failed == 0 and not correct),
              "metrics": metrics, "device": device}
    cold_build = bool(built_libraries() - libraries)
    result["cold_build"] = cold_build
    print(f"benchmark: cold_build {cold_build} (the program's libraries built in this run)",
          file=sys.stderr)
    if timeline is not None:
        # each card's busy share of its own traced window, on rank 0's window
        share = [timeline["busy_s"] / timeline["span_s"] if b is None else b
                 for b in records.get("busy_share_ranks", [None])]
        device.update(busy_s=sum(share) / len(share) * timeline["span_s"], window_s=timeline["span_s"])
        result["breakdown"] = {"device_ops": timeline["device_ops"], "idle_gaps": timeline["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}

    # the last step: whatever the window, the trace readers, the metric
    # readers and the reference loaded is in sys.modules by now
    found = forbidden_modules()
    if hasattr(entry, "forbidden_modules"):
        found += entry.forbidden_modules(state)
    if found:
        raise Refused(f"modules of JAX or of the JAX package are loaded: {', '.join(found)}")
    return result


class _Profiler:
    """torch.profiler over the window, marked as the user annotation
    "window"; `timeline` reads the Chrome trace it wrote."""

    REGION = "window"

    def __init__(self, scratch: str):
        self.path = os.path.join(scratch, "window.trace.json")

    def __enter__(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.mark = torch.profiler.record_function(self.REGION)
        self.mark.__enter__()
        return self

    def __exit__(self, *exc):
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.mark.__exit__(*exc)
        self.prof.__exit__(*exc)
        if exc[0] is None:
            self.prof.export_chrome_trace(self.path)
        return False

    def timeline(self) -> dict:
        from timeline import read_timeline

        tl = read_timeline(self.path, self.REGION)
        os.remove(self.path)
        return tl

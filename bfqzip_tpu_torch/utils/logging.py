"""Per-run logging of the port: step timers, subprocess capture, per-phase memory.

The same contract and log format as bfqzip_tpu/utils/logging.py (the
reference's BASENAME.log: command lines, wall-clock per step, peak heap per
phase), with device memory read through profiling.device_memory_stats.
Each step records its wall seconds, the host RSS high-water delta across
it, and, for a CUDA device, `bytes_in_use`, `peak_bytes_in_use` (reset at
the start of each step, so it is that step's peak) and `bytes_limit`; for
the CPU it records no device memory.
"""

from __future__ import annotations

import contextlib
import resource
import subprocess
import sys
import time
from typing import List

import torch

from bfqzip_tpu_torch.utils.profiling import device_memory_stats


def _rss_kb() -> int:
    # ru_maxrss is KB on Linux; a high-water mark, so per-step deltas show
    # which phase pushed the peak (0 for phases under an earlier peak)
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss


class StepLogger:
    def __init__(self, path: str, device):
        self.path = path
        self.f = open(path, "a")
        self.phases: List[dict] = []
        self.device = torch.device(device)

    def _cuda(self) -> bool:
        return self.device.type == "cuda"

    def info(self, msg: str) -> None:
        print(msg)
        print(msg, file=self.f)
        self.f.flush()

    def command_line(self) -> None:
        print("command line: " + " ".join(sys.argv), file=self.f)
        self.f.flush()

    @contextlib.contextmanager
    def step(self, name: str):
        t0 = time.time()
        rss0 = _rss_kb()
        if self._cuda():
            torch.cuda.reset_peak_memory_stats(self.device)
        self.info(f"--- {name} ---")
        try:
            yield
        finally:
            if self._cuda():
                torch.cuda.synchronize(self.device)
            rec = {
                "phase": name,
                "seconds": time.time() - t0,
                "host_rss_delta_mb": round((_rss_kb() - rss0) / 1024.0, 2),
                "host_rss_peak_mb": round(_rss_kb() / 1024.0, 2),
            }
            rec.update(device_memory_stats(self.device))
            mem = f"  host_rss_delta={rec['host_rss_delta_mb']:.1f}MB"
            if "peak_bytes_in_use" in rec:
                mem += (
                    f"  dev_in_use={rec['bytes_in_use']/2**20:.1f}MB"
                    f"  dev_peak={rec['peak_bytes_in_use']/2**20:.1f}MB"
                )
            self.phases.append(rec)
            self.info(f"    elapsed: {rec['seconds']:.4f}s{mem}")

    def run(self, cmd) -> None:
        """Run a subprocess with output captured into the log (the reference's
        execute_command, BFQzip.py:328-336)."""
        print("$ " + " ".join(cmd), file=self.f)
        self.f.flush()
        subprocess.check_call(cmd, stdout=self.f, stderr=self.f)

    def close(self) -> None:
        self.f.close()

"""Per-run logging of the port: bfqzip_tpu's StepLogger with device memory
read from torch instead of jax.

The shared logger reads device memory through jax in every step.  This one
records, for a CUDA device, `bytes_in_use` (torch.cuda.memory_allocated),
`peak_bytes_in_use` (torch.cuda.max_memory_allocated, reset at the start of
each step, so it is that step's peak) and `bytes_limit` (the card's total
memory); for the CPU it records none.  Log lines and `phases` records keep
the shared logger's format.
"""

from __future__ import annotations

import contextlib
import time

import torch

from bfqzip_tpu.utils import logging as _shared


class StepLogger(_shared.StepLogger):
    def __init__(self, path: str, device=None):
        super().__init__(path)
        self.device = torch.device(device) if device is not None else None

    def _cuda(self) -> bool:
        return self.device is not None and self.device.type == "cuda"

    @contextlib.contextmanager
    def step(self, name: str):
        t0 = time.time()
        rss0 = _shared._rss_kb()
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
                "host_rss_delta_mb": round((_shared._rss_kb() - rss0) / 1024.0, 2),
                "host_rss_peak_mb": round(_shared._rss_kb() / 1024.0, 2),
            }
            mem = f"  host_rss_delta={rec['host_rss_delta_mb']:.1f}MB"
            if self._cuda():
                rec["bytes_in_use"] = torch.cuda.memory_allocated(self.device)
                rec["peak_bytes_in_use"] = torch.cuda.max_memory_allocated(self.device)
                rec["bytes_limit"] = torch.cuda.get_device_properties(self.device).total_memory
                mem += (
                    f"  dev_in_use={rec['bytes_in_use']/2**20:.1f}MB"
                    f"  dev_peak={rec['peak_bytes_in_use']/2**20:.1f}MB"
                )
            self.phases.append(rec)
            self.info(f"    elapsed: {rec['seconds']:.4f}s{mem}")

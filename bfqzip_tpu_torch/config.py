"""Runtime configuration (the port's copy of bfqzip_tpu/config.py).

The reference splits its configuration across three tiers (compile-time -DM/-DB
macros in src_int_mem/Makefile:12-20, getopt runtime flags in bfq_int.cpp:883-935,
and argparse in BFQzip.py:32-47).  Here everything is a single runtime config; no
compile-time strategy forks.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SmoothConfig:
    """Parameters of the cluster-smoothing core.

    Defaults mirror the reference's invocation `bfq_int ... -m 5`
    (BFQzip.py:215) on top of the binary's own defaults (bfq_int.cpp:69-91):
    K=16, quality_threshold=20, freq_threshold=40, default '>' (QS 29), M=2, B=0.
    """

    # minimum LCP required inside clusters (bfq_int.cpp:70 `K_def`)
    k: int = 16
    # minimum cluster length to process; BFQzip.py passes 5 (BFQzip.py:215)
    min_cluster: int = 5
    # smoothing strategy: 0=max_qs, 1=mean_error, 2=constant, 3=avg_qs
    # (compile-time M in the reference, bfq_int.cpp:462-473)
    mode: int = 2
    # constant replacement quality, raw ASCII (bfq_int.cpp:78 `default_value_def`)
    default_qs: int = ord(">")
    # quality score threshold for trusted bases (bfq_int.cpp:82)
    quality_threshold: int = 20
    # percentage threshold for frequent bases (bfq_int.cpp:86)
    freq_threshold: float = 40.0
    # Illumina 8-level binning (compile-time B in the reference, bfq_int.cpp:784-786)
    binning: bool = False
    # number of positions excluded/included at cluster borders (bfq_int.cpp:67)
    border: int = 1

    def __post_init__(self):
        if self.mode not in (0, 1, 2, 3):
            raise ValueError(f"smoothing mode must be in 0..3, got {self.mode}")
        if self.k < 1:
            raise ValueError("k must be >= 1")

    @property
    def mode_name(self) -> str:
        """Strategy name for the runtime mode (the reference's compile-time -DM
        fork, src_int_mem/Makefile:12-16 / bfq_int.cpp:307-373,462-473)."""
        return ("max_qs", "mean_error", "constant", "avg_qs")[self.mode]


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """End-to-end pipeline configuration (the BFQzip.py argparse surface)."""

    smooth: SmoothConfig = dataclasses.field(default_factory=SmoothConfig)
    # output mode: 1=FASTQ stream, 2=DNA+QS streams, 3=DNA+QS+headers, 0=no compression
    # (BFQzip.py:39-42)
    mode: int = 3
    headers: bool = False
    # step-level artifact caching: skip EBWT build if artifacts exist (BFQzip.py:93-104)
    rebuild: bool = False
    # skip the smoothing core entirely (BFQzip.py:38 `--original`)
    original: bool = False
    # maximum read length the pipeline pads to; unlike the reference's 255-bp type
    # cap (src_ext_mem/parameters.h:66-74) this is a per-run shape choice.
    max_read_len: Optional[int] = None
    # entropy-coding backends to run ("rans" native; "ppmd"/"bsc" shell out when
    # the external binaries exist, BFQzip.py:22-23)
    codecs: tuple = ("rans",)

    def __post_init__(self):
        if self.mode not in (0, 1, 2, 3):
            raise ValueError(f"pipeline mode must be in 0..3, got {self.mode}")

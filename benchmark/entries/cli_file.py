"""Entry `cli_file`: FASTQ files through the program's CLI, in process.

Set-up makes `traffic.reads` reads of the configuration on the card from the
seed and writes them once as a FASTQ file under the run's scratch directory
(TMPDIR), then runs the traffic's `warmup_calls` files.  A call is
`cli.main([IN.fastq, "-o", BASE, *traffic.cli_args])` with a fresh output
base, so every file takes a user's first run (parse, fingerprint, step 1
with its artifacts, step 3, the .fq); its units are the file's bases.  The
program's StepLogger writes each step's wall seconds to BASE.log, which is
read back as the file's phases.  Every output base but the kept one is
deleted after its file.  The check compares the kept file's .fq, .bwt,
.bwt.qs and .lcp bytes with the plain reference's.
"""

from __future__ import annotations

import contextlib
import glob
import os
import sys
import time

import numpy as np
import torch

from gen import reads as gen
from reference import ebwt as ref


def setup(ctx):
    from bfqzip_tpu_torch import cli

    reads = dict(ctx.config["reads"], **ctx.traffic.get("reads", {}))
    seqs, quals, lengths = gen.make(reads, ctx.seed, ctx.device)
    state = {"ctx": ctx, "cli": cli, "files": [], "count": 0, "peak": 0,
             "seqs": seqs.cpu().numpy(), "quals": quals.cpu().numpy(),
             "lengths": lengths.cpu().numpy()}
    del seqs, quals, lengths
    state["bases"] = int(state["lengths"].sum())
    state["input"] = os.path.join(ctx.scratch, "in.fastq")
    with open(state["input"], "wb") as f:
        f.write(gen.fastq_bytes(state["seqs"], state["quals"]))
    for _ in range(ctx.traffic["warmup_calls"]):
        discard(state, _file(state)[1])
    state["files"].clear()
    state["peak"] = 0
    return state


def _file(state):
    ctx = state["ctx"]
    state["count"] += 1
    base = os.path.join(ctx.scratch, f"out{state['count']}")
    args = [state["input"], "-o", base, *ctx.traffic["cli_args"]]
    if ctx.device == "cpu":
        args.append("--cpu")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        rc = state["cli"].main(args)
    seconds = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"cli.main returned {rc} on {args}")
    phases = _phases(base + ".log")
    state["files"].append({"seconds": seconds, "phases": phases})
    state["peak"] = max([state["peak"]] + [p.get("peak_bytes", 0) for p in phases])
    return state["bases"], base


def _phases(log_path: str) -> list:
    """The steps StepLogger wrote: '--- name ---' then '    elapsed: Xs ...'."""
    phases, name = [], None
    with open(log_path) as f:
        for line in f:
            if line.startswith("--- ") and line.rstrip().endswith(" ---"):
                name = line.strip()[4:-4]
            elif name is not None and line.strip().startswith("elapsed:"):
                fields = line.split()
                rec = {"phase": name, "seconds": float(fields[1].rstrip("s"))}
                for f_ in fields[2:]:
                    if f_.startswith("dev_peak="):
                        rec["peak_bytes"] = int(float(f_[9:].rstrip("MB")) * 2**20)
                phases.append(rec)
                name = None
    return phases


def call(state):
    return _file(state)


def discard(state, base):
    for path in glob.glob(glob.escape(base) + ".*"):
        os.remove(path)


def peak_bytes(state):
    """StepLogger resets the device peak at each step; the largest step peak."""
    return state["peak"]


def traced(state):
    return {"files": list(state["files"])}


def control(state):
    """The control of `correct` (control.py): the CLI's -B, Illumina 8-level
    binning, qualities below the configuration's precision."""
    ctx = state["ctx"]
    ctx.traffic = dict(ctx.traffic, cli_args=list(ctx.traffic["cli_args"]) + ["-B"])


def release(state):
    state.pop("cli", None)


def _mismatch(got: bytes, want: bytes) -> int:
    a = np.frombuffer(got, dtype=np.uint8)
    b = np.frombuffer(want, dtype=np.uint8)
    k = min(a.size, b.size)
    return int((a[:k] != b[:k]).sum()) + abs(a.size - b.size)


def check(state, base):
    dev = state["ctx"].device
    cfg = dict(state["ctx"].config["smooth"])
    want = ref.smooth_reads(*(torch.as_tensor(state[k]).to(dev) for k in ("seqs", "quals", "lengths")),
                            cfg, artifacts=True)
    table = np.frombuffer(ref.DECODE, dtype=np.uint8)
    expected = {
        ".fq": ref.fastq_bytes(want["seqs"], want["quals"], state["lengths"]),
        ".bwt": table[want["bwt"].cpu().numpy()].tobytes(),
        ".bwt.qs": want["qs"].cpu().numpy().tobytes(),
        ".lcp": want["lcp"].cpu().numpy().astype("<u2").tobytes(),
    }
    checks = {}
    for ext, data in expected.items():
        path = base + ext
        got = open(path, "rb").read() if os.path.exists(path) else b""
        checks[f"{ext[1:]}_byte_mismatches"] = (_mismatch(got, data), 0)
    discard(state, base)
    return checks


def close(state):
    pass

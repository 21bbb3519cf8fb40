"""Entry `cli_ext`: a FASTQ file larger than the card through the CLI's
out-of-core route (`--ext-mem --mem MB`), in process.

Set-up makes the configuration's reads on the card from the seed and writes
them once as a FASTQ file under the run's scratch directory (TMPDIR), where
the program's spill files go too (BFQ_SPILL_DIR); a scratch disk that cannot
hold the input, the spill files and the output fails set-up, so that no run
falls back to host RAM unseen.  It then runs the traffic's `warmup_calls`
files.  A call is `cli.main([IN.fastq, "-o", BASE, *traffic.cli_args])`
with a fresh output base; its units are the file's bases.  The program's
StepLogger writes each step's wall seconds and device peak to BASE.log, and
`-v` prints the out-of-core report (`external: {...}`), which is read back
from the call's standard output.  Every output base but the kept one is
deleted after its file.

The check compares the kept file's .fq with the plain reference's bytes and
holds the configuration's guarantees: the out-of-core step's device peak
within the budget (`--mem`), a file larger than the budget in core split
into at least two chunk sorts and two smoothing segments, and, where the
program's report says (`spill`), the host arrays in spill files.
"""

from __future__ import annotations

import ast
import contextlib
import glob
import io
import os
import shutil
import sys

import torch

from gen import reads as gen
from harness import Refused, load_module
from reference import ebwt as ref

cli_file = load_module("entries", "cli_file")  # its StepLogger reader and byte comparison

# device bytes a position of the in-core engine (the hiseq101 deployment's
# figure): a file above the budget at this rate cannot be smoothed in one piece
IN_CORE_BYTES_PER_POS = 191
# spill bytes a position the program projects for its host arrays (21 with
# 32-bit positions), besides the input, its parsed arrays and the .fq
SPILL_BYTES_PER_POS = 21
EXT_STEP = "steps1-3: external memory"


def _budget_bytes(cli_args) -> int:
    return int(cli_args[list(cli_args).index("--mem") + 1]) << 20


def setup(ctx):
    from bfqzip_tpu_torch import cli

    reads = dict(ctx.config["reads"], **ctx.traffic.get("reads", {}))
    seqs, quals, lengths = gen.make(reads, ctx.seed, ctx.device)
    state = {"ctx": ctx, "cli": cli, "count": 0, "peak": 0,
             "seqs": seqs.cpu().numpy(), "quals": quals.cpu().numpy(),
             "lengths": lengths.cpu().numpy(), "spill_dir": os.environ.get("BFQ_SPILL_DIR")}
    del seqs, quals, lengths
    n_reads, width = state["seqs"].shape
    state["bases"] = int(state["lengths"].sum())
    state["input"] = os.path.join(ctx.scratch, "in.fastq")
    data = gen.fastq_bytes(state["seqs"], state["quals"])
    need = 2 * len(data) + 2 * n_reads * width + SPILL_BYTES_PER_POS * n_reads * (width + 1)
    free = shutil.disk_usage(ctx.scratch).free
    if free < need:
        raise Refused(f"the scratch disk {ctx.scratch} has {free / 1e9:.1f} GB free, and a call "
                      f"needs {need / 1e9:.1f} GB for its input, spill files and output")
    with open(state["input"], "wb") as f:
        f.write(data)
    del data
    os.environ["BFQ_SPILL_DIR"] = ctx.scratch
    for _ in range(ctx.traffic["warmup_calls"]):
        discard(state, _file(state)[1])
    state["peak"] = 0
    return state


def _file(state):
    ctx = state["ctx"]
    state["count"] += 1
    base = os.path.join(ctx.scratch, f"out{state['count']}")
    args = [state["input"], "-o", base, *ctx.traffic["cli_args"]]
    if ctx.device == "cpu":
        args.append("--cpu")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = state["cli"].main(args)
    sys.stderr.write(out.getvalue())
    if rc != 0:
        raise RuntimeError(f"cli.main returned {rc} on {args}")
    phases = cli_file._phases(base + ".log")
    report = _report(out.getvalue())
    state["peak"] = max([state["peak"]] + [p.get("peak_bytes", 0) for p in phases])
    return state["bases"], (base, phases, report)


def _report(stdout: str) -> dict:
    """The out-of-core report that `-v` prints as `external: {...}`; {} without one."""
    for line in stdout.splitlines():
        if line.startswith("external: "):
            return ast.literal_eval(line[len("external: "):])
    return {}


def call(state):
    return _file(state)


def discard(state, output):
    for path in glob.glob(glob.escape(output[0]) + ".*"):
        os.remove(path)


def begin_window(state, trace):
    """With a trace: the process's resident set sampled over the window."""
    from bfqzip_tpu_torch.utils import profiling

    sampler = getattr(profiling, "RssSampler", None)
    state["rss"] = sampler().__enter__() if trace and sampler is not None else None


def end_window(state, trace):
    if state["rss"] is not None:
        state["rss"].__exit__(None, None, None)


def peak_bytes(state):
    """StepLogger resets the device peak at each step; the largest step peak."""
    return state["peak"]


def traced(state):
    rss = state.get("rss")
    return {"rss": None if rss is None else {"start": rss.start, "peak": rss.peak}}


def control(state):
    """The control of `correct` (control.py): the CLI's -B, Illumina 8-level
    binning, qualities below the configuration's precision."""
    ctx = state["ctx"]
    ctx.traffic = dict(ctx.traffic, cli_args=list(ctx.traffic["cli_args"]) + ["-B"])


def release(state):
    state.pop("cli", None)


def check(state, output):
    base, phases, report = output
    ctx = state["ctx"]
    reads = (torch.as_tensor(state[k]).to(ctx.device) for k in ("seqs", "quals", "lengths"))
    want = ref.smooth_reads(*reads, dict(ctx.config["smooth"]))
    expected = ref.fastq_bytes(want["seqs"], want["quals"], state["lengths"])
    del want
    got = open(base + ".fq", "rb").read() if os.path.exists(base + ".fq") else b""
    checks = {"fq_byte_mismatches": (cli_file._mismatch(got, expected), 0)}
    del got, expected

    budget = _budget_bytes(ctx.traffic["cli_args"])
    step = [p for p in phases if p["phase"].startswith(EXT_STEP)]
    # no such step: the route did not run, and nothing bounds its peak
    excess = max(step[0].get("peak_bytes", 0) - budget, 0) if step else budget
    checks["budget_excess_bytes"] = (excess, 0)

    n_reads, width = state["seqs"].shape
    pieces = 2 if n_reads * (width + 1) * IN_CORE_BYTES_PER_POS > budget else 1
    checks["chunks_short"] = (max(pieces - int(report.get("n_chunks", 0)), 0), 0)
    checks["segments_short"] = (max(pieces - int(report.get("n_segments", 0)), 0), 0)
    if "spill" in report:
        checks["spill_fallbacks"] = (int(not report["spill"]), 0)
    discard(state, output)
    return checks


def close(state):
    if state["spill_dir"] is None:
        os.environ.pop("BFQ_SPILL_DIR", None)
    else:
        os.environ["BFQ_SPILL_DIR"] = state["spill_dir"]

"""Entry `cli_m3`: FASTQ files with read names archived through the CLI's
mode 3 (`--m3`), in process.

Set-up makes `reads` of the configuration on the card from the seed, and
the configuration's `headers` (read names, gen/headers.py) on the host from
the same seed, and writes them once as a FASTQ file under the run's
scratch directory (TMPDIR); then it runs the traffic's `warmup_calls`
files.  A call is `cli.main([IN.fastq, "-o", BASE, *traffic.cli_args])`
with a fresh output base: steps 1-3 (as in `cli_file`), the .h and the .fq
with the input's names, step 4's DNA and quality streams and step 5's
three archives.  Its units are the file's bases.  Every output base but the
kept one is deleted after its file.

Where the program keeps `pipeline.codec_streams` (one record a stream that
step 5 wrote), each file's archive bytes are read from it after the call;
without it they are None.

The check holds the kept file to the configuration's guarantees: its .fq,
.fq.dna, .fq.qs and .h equal reference/streams.py's bytes over
reference/ebwt.py's smoothing; `--restore` of its archives, through the
CLI, gives back the reference's .fq; and the archives' total size is at
most `ratio_ceiling` times the input's: the traffic's where it gives one
(the CPU tests' small files, whose models learn less), else the
configuration's.
"""

from __future__ import annotations

import contextlib
import math
import os
import sys
import traceback

import torch

from gen import headers as gen_headers
from gen import reads as gen
from harness import load_module
from reference import ebwt as ref
from reference import streams as ref_streams

cli_file = load_module("entries", "cli_file")  # its call, StepLogger reader and byte comparison

ARCHIVES = (".fq.dna.rans", ".fq.qs.rans", ".h.rans")
STREAMS = {".fq": "fq_byte_mismatches", ".fq.dna": "dna_stream_mismatches",
           ".fq.qs": "qs_stream_mismatches", ".h": "h_stream_mismatches"}


def setup(ctx):
    from bfqzip_tpu_torch import cli, pipeline

    reads = dict(ctx.config["reads"], **ctx.traffic.get("reads", {}))
    seqs, quals, lengths = gen.make(reads, ctx.seed, ctx.device)
    state = {"ctx": ctx, "cli": cli, "counter": getattr(pipeline, "codec_streams", None),
             "files": [], "count": 0, "peak": 0,
             "seqs": seqs.cpu().numpy(), "quals": quals.cpu().numpy(),
             "lengths": lengths.cpu().numpy()}
    del seqs, quals, lengths
    state["bases"] = int(state["lengths"].sum())
    state["headers"] = gen_headers.make(ctx.config["headers"], len(state["lengths"]), ctx.seed)
    state["input"] = os.path.join(ctx.scratch, "in.fastq")
    data = ref_streams.fastq_bytes(state["seqs"], state["quals"], state["lengths"], state["headers"])
    state["input_bytes"] = len(data)
    with open(state["input"], "wb") as f:
        f.write(data)
    del data
    for _ in range(ctx.traffic["warmup_calls"]):
        discard(state, call(state)[1])
    state["files"].clear()
    state["peak"] = 0
    return state


def call(state):
    counter = state["counter"]
    if counter is not None:
        counter.clear()
    units, base = cli_file._file(state)
    state["files"][-1]["archive_bytes"] = (None if counter is None
                                           else sum(s["out_bytes"] for s in counter))
    return units, base


discard = cli_file.discard
peak_bytes = cli_file.peak_bytes
control = cli_file.control


def traced(state):
    return {"files": list(state["files"]), "input_bytes": state["input_bytes"]}


def release(state):
    state.pop("cli", None)


def _read(path: str) -> bytes:
    if not os.path.exists(path):
        return b""
    with open(path, "rb") as f:
        return f.read()


def check(state, base):
    from bfqzip_tpu_torch import cli

    ctx = state["ctx"]
    reads = (torch.as_tensor(state[k]).to(ctx.device) for k in ("seqs", "quals", "lengths"))
    want = ref.smooth_reads(*reads, dict(ctx.config["smooth"]))
    expected = ref_streams.m3_streams(want["seqs"], want["quals"], state["lengths"],
                                      state["headers"])
    del want
    checks = {name: (cli_file._mismatch(_read(base + ext), expected[ext]), 0)
              for ext, name in STREAMS.items()}

    restored = base + ".restored.fastq"
    args = [base, "--restore", "-o", restored] + (["--cpu"] if ctx.device == "cpu" else [])
    try:
        with contextlib.redirect_stdout(sys.stderr):
            rc = cli.main(args)
    except Exception:  # an archive that cannot be restored gives back nothing
        traceback.print_exc(file=sys.stderr)
        rc = None
    got = _read(restored) if rc == 0 else b""
    checks["restored_byte_mismatches"] = (cli_file._mismatch(got, expected[".fq"]), 0)
    del got, expected

    archive = sum(os.path.getsize(base + ext) for ext in ARCHIVES if os.path.exists(base + ext))
    ceiling = ctx.traffic.get("ratio_ceiling", ctx.config["ratio_ceiling"])
    print(f"benchmark: archive {archive} bytes, ratio {archive / state['input_bytes']:.6f} "
          f"(ceiling {ceiling})", file=sys.stderr)
    checks["archive_excess_bytes"] = (max(math.ceil(archive - ceiling * state["input_bytes"]), 0), 0)
    discard(state, base)
    return checks


def close(state):
    pass

"""Entry `sharded`: ONE EBWT over the cards, through parallel.smooth_fastq_sharded(comm=).

Rank 0 is the harness's own process.  Set-up starts ranks 1..d-1 as
processes of this file, which join a group of d ranks (NCCL, one card each;
gloo on the CPU) through a FileStore in the run's scratch directory under
TMPDIR.  They get only the configuration's name, the seed and the sizes as
arguments: rank 0 makes the reads from the seed on its card and broadcasts
them, and every rank copies the whole batch to its host once, as each rank
of a `--mesh` run holds it.  Rank 0 then drives the group with a command
word that it broadcasts before each step (a call, a peak reset or reading,
a trace on or off, the reports, the control's binning, the search of each
rank's sys.modules for JAX, stop); the other ranks only return numbers and
names.

A call is smooth_fastq_sharded(batch, cfg, comm=comm) on every rank; its
units are the batch's bases and its output rank 0's whole smoothed batch.
This is the library's API with the ranks kept alive between calls; the
CLI's `--mesh D` (smooth_fastq_sharded(shards=D)) spawns the ranks, starts
the group and moves the batch through shared-memory tensors in every call,
which this entry does once in set-up or not at all.
The program marks the stages of every call (it waits for the card and
resets the card's peak counter at each mark) and reports each stage's ms
and peak bytes, the attempts and the collective bytes; the entry keeps the
last report and the largest stage peak of each rank.  The traced run
profiles every rank over the window (each rank's busy share comes back to
rank 0) and gathers the ranks' last reports.  The check compares rank 0's
output with the plain reference, on rank 0's card.

    python3 benchmark/entries/sharded.py --rank R --world D --init FILE --config NAME --seed S ...
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
for _p in (ROOT, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from entries.smooth_fastq import compare_reads  # noqa: E402
from gen import reads as gen  # noqa: E402
from reference import ebwt as ref  # noqa: E402

STOP, CALL, RESET_PEAK, PEAK, TRACE_ON, TRACE_OFF, REPORTS, BINNING, MODULES = range(9)
JOIN_S = 300.0  # a rank that does not answer within this long is taken down


class _Rank:
    """One rank's side of the group: its Comm, batch and configuration."""

    def __init__(self, rank, world, init_file, config, seed, device, scratch):
        from bfqzip_tpu_torch.config import SmoothConfig
        from bfqzip_tpu_torch.parallel import mesh

        self.comm = mesh.init_group(rank, world, device, init_file, timeout_s=JOIN_S)
        self.dev = self.comm.device
        self.scratch = scratch
        self.cfg = SmoothConfig(**config["smooth"])
        reads = config["reads"]
        shape = (reads["count"], reads["length"])
        if rank == 0:
            seqs, quals, lengths = gen.make(reads, seed, self.dev)
        else:
            seqs = torch.empty(shape, dtype=torch.uint8, device=self.dev)
            quals = torch.empty(shape, dtype=torch.uint8, device=self.dev)
            lengths = torch.empty(shape[0], dtype=torch.int32, device=self.dev)
        import torch.distributed as dist

        for t in (seqs, quals, lengths):
            dist.broadcast(t, 0)
        from bfqzip_tpu_torch.io.fastq import ReadBatch

        self.batch = ReadBatch(seqs=seqs.cpu().numpy(), quals=quals.cpu().numpy(),
                               lengths=lengths.cpu().numpy())
        del seqs, quals, lengths
        self.profiler = None
        self.report: dict = {}
        self.peak = 0

    def command(self, word: int = 0) -> int:
        """Rank 0 sends `word`; every rank returns it."""
        import torch.distributed as dist

        t = torch.tensor([word], dtype=torch.int64, device=self.dev)
        dist.broadcast(t, 0)
        return int(t.item())

    def gather(self, obj) -> list:
        import torch.distributed as dist

        out = [None] * self.comm.d
        dist.all_gather_object(out, obj)
        return out

    def do(self, word: int):
        """One step of the group; the result on every rank."""
        from bfqzip_tpu_torch.parallel import smooth_fastq_sharded

        cuda = self.dev.type == "cuda"
        if word == CALL:
            # the program marks its stages on every call, resetting the
            # card's peak counter at each; its report keeps each stage's peak
            reports = []
            out = smooth_fastq_sharded(self.batch, self.cfg, comm=self.comm, reports=reports)
            self.report = reports[0]
            self.peak = max([self.peak] + [v for k, v in self.report.items() if k.endswith("_peak_bytes")])
            return out
        if word == REPORTS:
            return self.gather(self.report)
        if word == MODULES:
            import harness

            return self.gather(harness.forbidden_modules())
        if word == RESET_PEAK:
            if cuda:
                torch.cuda.synchronize(self.dev)
                torch.cuda.reset_peak_memory_stats(self.dev)
            self.peak = 0
            return None
        if word == PEAK:
            if cuda:
                torch.cuda.synchronize(self.dev)
                self.peak = max(self.peak, torch.cuda.max_memory_allocated(self.dev))
            return self.gather(self.peak)
        if word == BINNING:
            import dataclasses

            self.cfg = dataclasses.replace(self.cfg, binning=True)
            return None
        if word in (TRACE_ON, TRACE_OFF) and self.comm.rank == 0:
            # rank 0's window is traced by the harness itself
            return None if word == TRACE_ON else self.gather(None)
        if word == TRACE_ON:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
                torch.cuda.synchronize(self.dev)
            self.profiler = torch.profiler.profile(activities=acts)
            self.profiler.__enter__()
            self.mark = torch.profiler.record_function("rank_window")
            self.mark.__enter__()
            return None
        if word == TRACE_OFF:
            from timeline import read_timeline

            if cuda:
                torch.cuda.synchronize(self.dev)
            self.mark.__exit__(None, None, None)
            self.profiler.__exit__(None, None, None)
            path = os.path.join(self.scratch, f"rank{self.comm.rank}.trace.json")
            self.profiler.export_chrome_trace(path)
            tl = read_timeline(path, "rank_window")
            os.remove(path)
            return self.gather(tl["busy_s"] / tl["span_s"])
        raise ValueError(f"unknown command {word}")

    def close(self):
        import torch.distributed as dist

        dist.destroy_process_group()


def setup(ctx):
    world = ctx.cell["chips"] if ctx.device == "cuda" else ctx.traffic["cpu_ranks"]
    init_file = os.path.join(ctx.scratch, "group.store")
    args = ["--world", str(world), "--init", init_file, "--config", ctx.cell["config"],
            "--seed", str(ctx.seed), "--device", ctx.device, "--scratch", ctx.scratch,
            "--reads", json.dumps(ctx.config["reads"])]
    workers = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r), *args],
                                stdout=2) for r in range(1, world)]
    state = {"ctx": ctx, "workers": workers, "bases": 0, "peaks": [0]}
    try:
        rank = state["rank"] = _Rank(0, world, init_file, ctx.config, ctx.seed, ctx.device, ctx.scratch)
        state["bases"] = int(rank.batch.lengths.sum())
        for _ in range(ctx.traffic["warmup_calls"]):
            _step(state, CALL)
    except BaseException:
        close(state)
        raise
    return state


def _step(state, word):
    rank = state["rank"]
    rank.command(word)
    return rank.do(word)


def begin_window(state, trace):
    _step(state, RESET_PEAK)
    if trace:
        _step(state, TRACE_ON)


def call(state):
    out, stats = _step(state, CALL)
    return state["bases"], (out, stats)


def discard(state, output):
    pass


def end_window(state, trace):
    if trace:
        state["busy"] = _step(state, TRACE_OFF)
    state["peaks"] = _step(state, PEAK)


def peak_bytes(state):
    """The fullest card's peak over the window: the largest of each rank's
    stage peaks (the program's reports) and its counter since the last
    stage."""
    return max(state["peaks"])


def traced(state):
    """Each rank's busy share of its traced window (rank 0's is the
    harness's), and each rank's report of the window's last call (stage ms
    and peaks, attempts, collective bytes), also printed on stderr."""
    reports = _step(state, REPORTS)
    for r, rep in enumerate(reports):
        print(f"sharded: rank {r} last call {rep}", file=sys.stderr)
    n = state["bases"] + state["rank"].batch.num_reads
    return {"busy_share_ranks": state["busy"], "rank_reports": reports, "positions": n}


def control(state):
    """The control of `correct` (control.py): every rank switches on the
    program's Illumina 8-level binning, qualities below the configuration's
    precision."""
    _step(state, BINNING)


def forbidden_modules(state):
    """What each other rank's sys.modules holds of JAX and the JAX package,
    asked of every rank after the check (rank 0's own is the harness's)."""
    found = _step(state, MODULES)
    return [f"rank {r}: {m}" for r, names in enumerate(found) if r > 0 for m in names]


def release(state):
    pass


def check(state, output):
    got, got_stats = output
    batch = state["rank"].batch
    dev = state["rank"].dev
    cfg = dict(state["ctx"].config["smooth"])
    want = ref.smooth_reads(*(torch.as_tensor(a).to(dev) for a in
                              (batch.seqs, batch.quals, batch.lengths)), cfg)
    return compare_reads(got, got_stats, want, batch.lengths, dev)


def close(state):
    """Stop the ranks and wait for each; one that does not end is killed."""
    rank = state.get("rank")
    if rank is not None:
        try:
            rank.command(STOP)
            rank.close()
        except Exception as e:  # the group is broken: the ranks are ended below
            print(f"sharded: stopping the group failed: {e}", file=sys.stderr)
    deadline = time.monotonic() + JOIN_S
    for p in state["workers"]:
        try:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    bad = [p.returncode for p in state["workers"] if p.returncode != 0]
    if bad:
        print(f"sharded: ranks exited with {bad}", file=sys.stderr)


def worker_main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser()
    for name in ("--rank", "--world", "--seed"):
        p.add_argument(name, type=int, required=True)
    for name in ("--init", "--config", "--device", "--scratch", "--reads"):
        p.add_argument(name, required=True)
    a = p.parse_args(argv)
    import harness

    config = dict(harness.load_json(HERE, "configs", a.config + ".json"), reads=json.loads(a.reads))
    rank = _Rank(a.rank, a.world, a.init, config, a.seed, a.device, a.scratch)
    while True:
        word = rank.command()
        if word == STOP:
            break
        rank.do(word)
    rank.close()
    return 0


if __name__ == "__main__":
    sys.exit(worker_main())

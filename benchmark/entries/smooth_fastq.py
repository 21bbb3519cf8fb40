"""Entry `smooth_fastq`: one read batch through engine.smooth_fastq, back to back.

Set-up makes the configuration's reads on the card from the seed, copies
them to the host once (the numpy batch a caller hands to smooth_fastq) and
warms up with the traffic's `warmup_calls`.  A call is one smooth_fastq of
the whole batch: host arrays in, host arrays out, as the CLI runs one batch
at a time.  Its units are the batch's bases.  The check runs the plain
reference on the same reads, on the card, and compares every base,
quality, length and counter of the kept call's output.
"""

from __future__ import annotations

import statistics
import time

import torch

from gen import reads as gen
from reference import ebwt as ref

STAGE_PASSES = 3


def setup(ctx):
    from bfqzip_tpu_torch.config import SmoothConfig
    from bfqzip_tpu_torch.engine import smooth_fastq
    from bfqzip_tpu_torch.io.fastq import ReadBatch

    seqs, quals, lengths = gen.make(ctx.config["reads"], ctx.seed, ctx.device)
    batch = ReadBatch(seqs=seqs.cpu().numpy(), quals=quals.cpu().numpy(),
                      lengths=lengths.cpu().numpy())
    del seqs, quals, lengths
    cfg = SmoothConfig(**ctx.config["smooth"])
    state = {"ctx": ctx, "batch": batch, "cfg": cfg, "run": smooth_fastq,
             "bases": int(batch.lengths.sum())}
    for _ in range(ctx.traffic["warmup_calls"]):
        smooth_fastq(batch, cfg, device=ctx.device)
    return state


def call(state):
    out = state["run"](state["batch"], state["cfg"], device=state["ctx"].device)
    return state["bases"], out


def discard(state, output):
    pass


def traced(state):
    """The stage pass: the three calls engine.smooth_step makes, on the same
    reads, each ended by a synchronise; the median of a few passes, in ms."""
    from bfqzip_tpu_torch.convert import batch_to_tensors
    from bfqzip_tpu_torch.engine import pre_of
    from bfqzip_tpu_torch.ops.invert import invert_via_sa
    from bfqzip_tpu_torch.ops.smooth import smooth
    from bfqzip_tpu_torch.ops.suffix import build_ebwt

    dev = torch.device(state["ctx"].device)
    cfg = state["cfg"]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    seqs, quals, lengths = batch_to_tensors(state["batch"], dev)
    n_reads, width = seqs.shape
    times = {"build": [], "smooth": [], "invert": []}
    for _ in range(STAGE_PASSES):
        sync()
        t0 = time.perf_counter()
        ebwt = build_ebwt(seqs, quals, lengths)
        sync()
        t1 = time.perf_counter()
        out = smooth(ebwt, cfg, pre=pre_of(ebwt))
        sync()
        t2 = time.perf_counter()
        inv = invert_via_sa(ebwt.sa, ebwt.bwt, out.bwt_sub, out.qs, ebwt.n, n_reads, width,
                            binning=cfg.binning)
        sync()
        t3 = time.perf_counter()
        del ebwt, out, inv
        for k, dt in zip(times, (t1 - t0, t2 - t1, t3 - t2)):
            times[k].append(dt * 1e3)
    return {"stages_ms": {k: statistics.median(v) for k, v in times.items()},
            "n_reads": n_reads, "width": width}


def control(state):
    """The control of `correct` (control.py): the program's own Illumina
    8-level binning, qualities below the configuration's precision."""
    import dataclasses

    state["cfg"] = dataclasses.replace(state["cfg"], binning=True)


def release(state):
    state.pop("run", None)


def check(state, output):
    """Reference on the same reads; every mismatch counted (limit 0)."""
    got, got_stats = output
    batch = state["batch"]
    dev = state["ctx"].device
    cfg = dict(state["ctx"].config["smooth"])
    want = ref.smooth_reads(*(torch.as_tensor(a).to(dev) for a in
                              (batch.seqs, batch.quals, batch.lengths)), cfg)
    return compare_reads(got, got_stats, want, batch.lengths, dev)


def compare_reads(got, got_stats, want, lengths, dev) -> dict:
    """Mismatch counts between the program's output batch and the
    reference's, inside each read's length."""
    lens = torch.as_tensor(lengths).to(dev).to(torch.int64)
    width = want["seqs"].shape[1]
    inside = torch.arange(width, device=dev)[None, :] < lens[:, None]
    g_seqs, g_quals = (torch.as_tensor(a).to(dev) for a in (got.seqs, got.quals))
    if g_seqs.shape != want["seqs"].shape:
        shape_bad = g_seqs.numel() + want["seqs"].numel()
        return {"base_mismatches": (shape_bad, 0), "quality_mismatches": (shape_bad, 0),
                "length_mismatches": (len(lengths), 0), "counter_mismatches": (len(ref.STATS), 0)}
    g_lens = torch.as_tensor(got.lengths).to(dev).to(torch.int64)
    return {
        "base_mismatches": (int(((g_seqs != want["seqs"]) & inside).sum()), 0),
        "quality_mismatches": (int(((g_quals != want["quals"]) & inside).sum()), 0),
        "length_mismatches": (int((g_lens != lens).sum()), 0),
        "counter_mismatches": (sum(int(got_stats.get(k, -1) != want["stats"][k]) for k in ref.STATS), 0),
    }


def close(state):
    pass

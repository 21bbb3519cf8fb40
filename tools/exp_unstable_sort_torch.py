#!/usr/bin/env python3
"""Experiment: the build's LSD sort passes run unstably against the stable
ones, on real packed keys, and the same for the invert's sort, beside the
port's own invert route, a scatter.

The counterpart of tools/exp_unstable_sort.py (which sorts with
jax.lax.sort) for bfqzip_tpu_torch, on its reads: make(200000, 101, 0.6,
0, 0.005, 0.001) from tools/make_realistic.py.

Build half: the flat build's keys, ops/suffix.py::_pack on
convert.batch_to_tensors of the reads, sorted by ops/suffix.py::_sort_lsd
(stable passes, the build's) and by the same passes with stable=False.
LSD passes need stability for the suffix order, so `build_identical` says
whether this device's unstable sort kept every tie in order anyway.

Invert half: a random permutation `target` of the n_pad positions and a
random int32 payload.  The payload in target order three ways: a stable and
an unstable torch.sort(target) with a gather (`invert_identical`: the key
is a permutation, so the two must agree), and the scatter grid[target] =
payload that ops/invert.py::invert_via_sa does (`scatter_identical`).
`invert_via_sa_ms` times invert_via_sa itself on these reads' EBWT.

Each time is the best of --reps calls after a warm-up
(utils/profiling.best_ms: CUDA events on the card).

    python3 tools/exp_unstable_sort_torch.py [--reads 200000] [--reps 3] [--cpu]

Prints one JSON line naming the device with its power limit.  Without
--cpu it needs a card.  Imports nothing of jax or bfqzip_tpu.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

TOOLS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(TOOLS))
sys.path.insert(0, TOOLS)

from bfqzip_tpu_torch import alphabet  # noqa: E402
from bfqzip_tpu_torch.convert import batch_to_tensors  # noqa: E402
from bfqzip_tpu_torch.engine import resolve_device  # noqa: E402
from bfqzip_tpu_torch.io.fastq import ReadBatch  # noqa: E402
from bfqzip_tpu_torch.ops import suffix  # noqa: E402
from bfqzip_tpu_torch.ops.invert import invert_via_sa  # noqa: E402
from bfqzip_tpu_torch.utils.profiling import best_ms, device_info  # noqa: E402

READ_LEN = 101
GENOME_MB = 0.6


def reads(n_reads: int) -> ReadBatch:
    """The JAX tool's reads: make(n_reads, 101, 0.6, 0, 0.005, 0.001)."""
    from make_realistic import make

    seq_ascii, quals = make(n_reads, READ_LEN, GENOME_MB, 0, 0.005, 0.001)
    return ReadBatch(seqs=alphabet.encode(seq_ascii), quals=quals,
                     lengths=np.full(n_reads, READ_LEN, np.int32))


def _same(a: tuple, b: tuple) -> bool:
    return torch.equal(a[0], b[0]) and all(torch.equal(x, y) for x, y in zip(a[1], b[1]))


def run(n_reads: int, device, reps: int = 3) -> dict:
    dev = resolve_device(device)
    seqs, quals, lengths = batch_to_tensors(reads(n_reads), dev)
    lens, _ = suffix._lens_and_n(lengths)
    words = suffix._pack(seqs, lens)
    n_pad = words[0].shape[0]
    res = {"device": device_info(dev), "reads": n_reads, "read_len": READ_LEN, "n_pad": n_pad,
           "n_words": len(words), "reps": reps}
    res["build_stable_ms"] = best_ms(lambda: suffix._sort_lsd(words), dev, reps)
    res["build_unstable_ms"] = best_ms(lambda: suffix._sort_lsd(words, stable=False), dev, reps)
    res["build_identical"] = _same(suffix._sort_lsd(words), suffix._sort_lsd(words, stable=False))
    del words

    rng = np.random.default_rng(0)
    target = torch.as_tensor(rng.permutation(n_pad).astype(np.int32)).to(dev)
    payload = torch.as_tensor(rng.integers(0, 1 << 16, n_pad, dtype=np.int32)).to(dev)

    def by_sort(stable: bool):
        _, order = torch.sort(target, stable=stable)
        return payload[order]

    def by_scatter():
        grid = torch.empty_like(payload)
        grid[target.long()] = payload  # every slot receives exactly one entry
        return grid

    res["invert_stable_ms"] = best_ms(lambda: by_sort(True), dev, reps)
    res["invert_unstable_ms"] = best_ms(lambda: by_sort(False), dev, reps)
    res["invert_scatter_ms"] = best_ms(by_scatter, dev, reps)
    want = by_sort(True)
    res["invert_identical"] = bool(torch.equal(by_sort(False), want))
    res["scatter_identical"] = bool(torch.equal(by_scatter(), want))

    e = suffix.build_ebwt(seqs, quals, lengths)
    res["invert_via_sa_ms"] = best_ms(
        lambda: invert_via_sa(e.sa, e.bwt, e.bwt, e.qs, e.n, n_reads, READ_LEN), dev, reps)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--reads", type=int, default=200_000)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.reads, "cpu" if args.cpu else "cuda", args.reps)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

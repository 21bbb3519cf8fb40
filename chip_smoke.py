#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (bfqzip_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases, each printed on its own line; the first failure exits non-zero:
  1. environment  card name and power limit, torch/CUDA/nvcc versions, triton
  2. build        nvcc builds csrc/seg_scan.cu from the checkout
  3. kernel       the CUDA seg_scan against its plain PyTorch version on the
                  card: every op/dtype, C in {1, 5}, both directions, five
                  sizes and five flag patterns; integers bit-exact, float64
                  within 1e-12 relative error; kernel and plain ms at 20.4M
  4. goldens      the 18 reference-binary goldens of width <= 322 through
                  smooth_fastq(device="cuda"), byte-equal
  5. real size    2M x 101 bp realistic reads: warm-up + 3 timed
                  smooth_fastq runs, stage times, peak memory, kernel launch
                  counts, the identity round trip and kernel-vs-plain smooth
Then a JSON line describing each kernel, and last the result line
{"ok": true, "device": {...}}.  Imports no jax.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")
N_BENCH = 20_400_000  # 200K reads x 102 positions
REAL_READS, REAL_LEN = 2_000_000, 101


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def environment() -> str:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    from bfqzip_tpu_torch.utils import cuda_build

    nvcc = subprocess.run([cuda_build.find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    try:
        import triton

        triton_version = triton.__version__
    except ImportError as e:
        triton_version = f"not importable: {e}"
    phase("environment", nvidia_smi=smi, python=sys.version.split()[0], torch=torch.__version__,
          cuda=torch.version.cuda, nvcc=nvcc, triton=triton_version,
          device=torch.cuda.get_device_name(0), count=torch.cuda.device_count())
    return smi


def build() -> None:
    from bfqzip_tpu_torch.utils import cuda_build

    t = time.time()
    _, log = cuda_build.build("seg_scan")
    cuda_build.load("seg_scan")  # the library the wrapper uses
    ptxas = [ln for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    phase("build", seconds=time.time() - t, ptxas=ptxas)


def _flags(pattern: str, n: int, gen):
    import torch

    f = torch.zeros(n, dtype=torch.bool, device="cuda")
    if pattern == "all":
        f[:] = True
    elif pattern == "dense":
        f = torch.rand(n, generator=gen, device="cuda") < 0.003
    elif pattern == "first":
        f[0] = True
    elif pattern == "last":
        f[-1] = True
    return f


def _values(op: str, dtype, shape, gen):
    import torch

    if dtype == torch.float64:
        return torch.rand(shape, generator=gen, device="cuda", dtype=torch.float64)
    lo, hi = {"add": (0, 100), "max": (-1000, 1000), "or": (0, 2**31 - 1),
              "keepleft": (-(2**31), 2**31 - 1)}[op]
    return torch.randint(lo, hi, shape, generator=gen, device="cuda", dtype=torch.int32)


def kernel_vs_plain() -> float:
    import torch

    from bfqzip_tpu_torch.ops import cuda_scan
    from bfqzip_tpu_torch.ops.scan import INT32_MIN, seg_scan

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    pairs = [("add", torch.int32, 0), ("max", torch.int32, INT32_MIN), ("or", torch.int32, 0),
             ("keepleft", torch.int32, 0), ("add", torch.float64, 0.0)]
    max_abs, cases, timings = 0.0, 0, []
    for op, dtype, init in pairs:
        for C in (1, 5):
            for reverse in (False, True):
                for n in (1, 127, 4097, 1_000_003, N_BENCH):
                    for pattern in ("none", "all", "dense", "first", "last"):
                        shape = (n,) if C == 1 else (C, n)
                        x = _values(op, dtype, shape, gen)
                        f = _flags(pattern, n, gen)
                        got = cuda_scan.seg_scan(x, f, op, init, reverse)
                        if reverse:
                            want = seg_scan(x.flip(-1), f.flip(0), op, init).flip(-1)
                        else:
                            want = seg_scan(x, f, op, init)
                        torch.cuda.synchronize()
                        case = f"{op}/{dtype}/C={C}/rev={reverse}/n={n}/{pattern}"
                        if dtype == torch.float64:
                            err = (got - want).abs()
                            rel = (err / want.abs().clamp_min(1e-300)).max().item()
                            max_abs = max(max_abs, err.max().item())
                            if rel > 1e-12:
                                fail(f"kernel vs plain {case}: relative error {rel}")
                        else:
                            if not torch.equal(got, want):
                                fail(f"kernel vs plain {case}: not bit-exact")
                            max_abs = max(max_abs, (got.long() - want.long()).abs().max().item())
                        cases += 1
                        if n == N_BENCH and pattern == "dense":
                            timings.append({
                                "op": op, "dtype": str(dtype).split(".")[-1], "C": C,
                                "reverse": reverse, "n": n,
                                "ms": cuda_ms(lambda: cuda_scan.seg_scan(x, f, op, init, reverse), 20),
                                "plain_ms": cuda_ms(lambda: seg_scan(x, f, op, init), 3),
                            })
                        del x, f, got, want
    phase("kernel", cases=cases, max_abs_err=max_abs, timings=timings)
    return max_abs


def goldens() -> None:
    from bfqzip_tpu_torch import SmoothConfig
    from bfqzip_tpu_torch.engine import smooth_fastq
    from bfqzip_tpu_torch.io import format_fastq, read_fastq

    cfgs = {"m0b0": SmoothConfig(mode=0), "m1b0": SmoothConfig(mode=1), "m2b0": SmoothConfig(),
            "m3b0": SmoothConfig(mode=3), "m2b1": SmoothConfig(binning=True),
            "m2b0h": SmoothConfig()}
    done = []
    for ds in ("example", "example_r1", "synth_var"):
        batch = read_fastq(os.path.join(GOLDEN, f"{ds}.in.fastq"))
        for tag, cfg in cfgs.items():
            out, _ = smooth_fastq(batch, cfg, device="cuda")
            got = format_fastq(out) if tag == "m2b0h" else format_fastq(out, headers=None)
            with open(os.path.join(GOLDEN, f"{ds}.{tag}.fq"), "rb") as fh:
                if got != fh.read():
                    fail(f"golden {ds}.{tag} differs")
            done.append(f"{ds}.{tag}")
    phase("goldens", byte_equal=len(done), names=done)


def real_size() -> dict:
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_realistic import make

    from bfqzip_tpu_torch import SmoothConfig
    from bfqzip_tpu_torch.convert import batch_to_tensors
    from bfqzip_tpu_torch.engine import smooth_fastq
    from bfqzip_tpu_torch.io import ReadBatch, encode
    from bfqzip_tpu_torch.ops import cuda_scan
    from bfqzip_tpu_torch.ops.invert import invert_via_sa
    from bfqzip_tpu_torch.ops.scan import LocalScanOps, seg_scan
    from bfqzip_tpu_torch.ops.smooth import smooth
    from bfqzip_tpu_torch.ops.suffix import build_ebwt

    t = time.time()
    seq_ascii, quals = make(REAL_READS, REAL_LEN, 4.6, 0, 0.005, 0.001)
    batch = ReadBatch(seqs=encode(seq_ascii), quals=quals,
                      lengths=np.full(REAL_READS, REAL_LEN, np.int32))
    del seq_ascii
    t_data = time.time() - t
    cfg = SmoothConfig()
    total_bases = REAL_READS * REAL_LEN

    out, stats = smooth_fastq(batch, cfg, device="cuda")  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run_s, per_run = [], []
    cuda_scan.launches = 0
    for _ in range(3):
        before = cuda_scan.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        out, stats = smooth_fastq(batch, cfg, device="cuda")
        torch.cuda.synchronize()
        run_s.append(time.perf_counter() - t)
        per_run.append(cuda_scan.launches - before)
    launches = cuda_scan.launches
    peak = torch.cuda.max_memory_allocated()
    if min(per_run) < 5:
        fail(f"seg_scan kernel launched {per_run} times per smooth_fastq, expected >= 5")

    # output checks: shape, lengths, bounded changes
    if out.seqs.shape != batch.seqs.shape or not np.array_equal(out.lengths, batch.lengths):
        fail("smoothed batch has the wrong shape or read lengths")
    changed = int((out.seqs != batch.seqs).sum())
    if changed != stats["modified"] or stats["num_clust"] == 0:
        fail(f"smoothing changed {changed} bases for modified={stats['modified']}")

    # stage times on the same data
    seqs, qs_in, lengths = batch_to_tensors(batch, "cuda")
    stage = {}
    torch.cuda.synchronize()
    t = time.perf_counter()
    ebwt = build_ebwt(seqs, qs_in, lengths)
    torch.cuda.synchronize()
    stage["build_ms"] = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    sm = smooth(ebwt, cfg, pre=ebwt.pre)
    torch.cuda.synchronize()
    stage["smooth_ms"] = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    invert_via_sa(ebwt.sa, ebwt.bwt, sm.bwt_sub, sm.qs, ebwt.n, REAL_READS, REAL_LEN)
    torch.cuda.synchronize()
    stage["invert_ms"] = (time.perf_counter() - t) * 1e3

    # identity: inversion without smoothing gives the input back
    ident = invert_via_sa(ebwt.sa, ebwt.bwt, ebwt.bwt, ebwt.qs, ebwt.n, REAL_READS, REAL_LEN)
    if not (torch.equal(ident.seqs, seqs) and torch.equal(ident.quals, qs_in)
            and torch.equal(ident.lengths, lengths)):
        fail("identity round trip differs from the input reads")

    # kernel against the plain path through the whole smoother
    class PlainScanOps(LocalScanOps):
        def _scan(self, x, flag, op, init, reverse=False):
            if reverse:
                return seg_scan(x.flip(-1), flag.flip(0), op, init).flip(-1)
            return seg_scan(x, flag, op, init)

    plain = smooth(ebwt, cfg, pre=ebwt.pre, ops=PlainScanOps())
    if not (torch.equal(plain.bwt_sub, sm.bwt_sub) and torch.equal(plain.qs, sm.qs)):
        fail("smooth with the kernel differs from smooth with the plain scans")
    if {k: int(v) for k, v in plain.stats.items()} != {k: int(v) for k, v in sm.stats.items()}:
        fail("smooth stats differ between kernel and plain scans")
    del plain

    # the kernel at the main path's widest call: [5, n_pad] int32 add
    n_pad = ebwt.bwt.shape[0]
    X = (ebwt.bwt[None, :] == torch.arange(1, 6, device="cuda", dtype=torch.uint8)[:, None]).to(torch.int32)
    open_mark = torch.rand(n_pad, device="cuda") < 0.05
    got = cuda_scan.seg_scan(X, open_mark, "add", 0)
    want = seg_scan(X, open_mark, "add", 0)
    if not torch.equal(got, want):
        fail("kernel vs plain at the main path's [5, n_pad] shape: not bit-exact")
    ms = cuda_ms(lambda: cuda_scan.seg_scan(X, open_mark, "add", 0), 10)
    plain_ms = cuda_ms(lambda: seg_scan(X, open_mark, "add", 0), 2)
    del got, want, X

    res = {
        "reads": REAL_READS, "read_len": REAL_LEN, "n_pad": n_pad, "data_s": t_data,
        "run_s": run_s, "bases_per_s": total_bases / min(run_s),
        "bases_per_s_median": total_bases / sorted(run_s)[1], **stage,
        "peak_bytes": peak, "launches_per_run": per_run, "launches": launches,
        "stats": stats, "identity": True, "kernel_vs_plain_smooth": True,
        "scan_shape": [5, n_pad], "scan_ms": ms, "scan_plain_ms": plain_ms,
    }
    phase("real_size", **res)
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an NVIDIA GPU")
    smi = environment()
    build()
    max_abs = kernel_vs_plain()
    goldens()
    real = real_size()
    if "jax" in sys.modules:
        fail("jax was imported")
    print(json.dumps({"kernels": [{
        "name": "seg_scan", "route": "cuda", "source": "bfqzip_tpu_torch/csrc/seg_scan.cu",
        "replaces": "bfqzip_tpu/ops/pallas_scan.py:89", "launches": real["launches"],
        "max_abs_err": max_abs, "ms": real["scan_ms"], "plain_ms": real["scan_plain_ms"],
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

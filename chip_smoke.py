#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (bfqzip_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:  python3 chip_smoke.py

Phases, each printed on its own line; the first failure exits non-zero:
  1. environment  card name and power limit, torch/CUDA/nvcc versions, triton
  2. build        nvcc builds csrc/seg_scan.cu and c++ the out-of-core
                  merge csrc/extmerge.cpp from the checkout, both at once
  3. kernel       the CUDA seg_scan against its plain PyTorch version on the
                  card: every op/dtype (int32 and int64 add/max/or/keepleft,
                  int64 values past 2^31, float64 add), C in {1, 5} (odd n
                  gives misaligned rows), both directions, five sizes and the
                  tile edges k * tile + {-1, 0, 1} for k in {1, 33}, five flag
                  patterns, then a random per-channel tensor init (the
                  out-of-core carry) for every op/dtype pair; every case run
                  twice with bit-equal results; integers bit-exact, float64
                  within 1e-12 relative error; a look-back stress (one flag,
                  at position 0) at the main path's n_pad; kernel and plain
                  ms at 20.4M beside the bound
  4. goldens      all 24 reference-binary goldens through
                  smooth_fastq(device="cuda"), byte-equal (synth_long's
                  400-600 bp reads through the doubling build)
  5. real size    2M x 101 bp realistic reads: warm-up + 3 timed
                  smooth_fastq runs, stage times, peak memory, kernel launch
                  counts, the identity round trip and kernel-vs-plain smooth;
                  then each seg_scan launch of one smooth on its own inputs:
                  bit-exact against the plain version, kernel / plain /
                  library (torch.cumsum or torch.cummax) ms beside the bound
  6. cli          the native codec library (make -B -C native, started at the
                  beginning) must load; the phase-5 reads as a FASTQ through
                  bfqzip_tpu_torch.cli -0 --rebuild (steps 1-3 through the
                  cached artifacts and the LF walk) byte-equal to
                  smooth_fastq's, >= 6 seg_scan launches, a cached re-run
                  that skips step 1 with the same bytes, lf_array / smooth /
                  LF walk timed alone; then 200K reads through --m3,
                  --restore and --decompress, byte-equal, with MB/s
  7. long reads   300K x 600 bp through the doubling build: smooth_fastq
                  with its seg_scan launches, build / smooth / invert ms,
                  peak device bytes, the identity round trip, changed bases
                  == modified, kernel-vs-plain smooth
  8. external     the out-of-core path: (a) the phase-6 FASTQ through
                  cli --ext-mem --mem 4096 -0 (the merge overlapped with
                  smoothing), byte-equal to phase 6's in-core .fq, >= 8
                  chunks and >= 4 segments, peak device bytes within the
                  budget; (b) 500K reads with BFQ_EXT_SA64=1 (int64
                  coordinates and kernel scans) equal to the int32 route;
                  (c) 4M x 101 bp (404M positions, more than one card holds
                  in memory) under an 8 GiB budget with spill files, three
                  times: the merge overlapped (the default), serial
                  (BFQ_EXT_OVERLAP=0) and overlapped on the cores minus 2
                  threads, equal by a digest of the smoothed reads taken
                  before the spill closes; each run's seconds, bases/s,
                  chunk-sort / merge / merge-wait / smooth / emit seconds,
                  prefix curve, peak device bytes within the budget, peak
                  host RSS, launches per segment; (d) a chunk sort's peak
                  bytes per position at widths 101-1000 bp within the
                  constant that sizes the chunks, and 400K x 250 bp under a
                  2 GiB budget, peak within it and byte-equal to
                  smooth_fastq; (e) tools/bench_extmerge_torch.py on 250K of
                  phase 6's reads: the port's merge threaded and on one
                  thread, with and without chunk LCPs (all equal), and the
                  live merge's prefix curve with one and eight ranges per
                  thread.  In (a), (c) and (d) one middle segment is rerun
                  with the plain scans on its recorded window and carries:
                  every output equal
  9. sharded      the sequence-sharded pipeline (bfqzip_tpu_torch.parallel):
                  (a) smooth_fastq_sharded as the one rank of an NCCL group,
                  at the largest count (<= 2M) of phase 5's reads whose peak
                  stays under 70 GB, sized from the bytes per position of a
                  200K-read probe: byte-equal to smooth_fastq with equal
                  stats, best and median of 3 timed calls after a warm-up,
                  stage ms, peak device bytes, seg_scan launches per call,
                  collective bytes, and each launch of one call held against
                  the plain version and timed beside its bound; (b) 4 ranks
                  sharing the card through a gloo group (collectives staged
                  through the host, bytes counted): the flat body at 200K
                  reads, the doubling body at 30K x 150 bp and a forced
                  overflow whose retry gives the same bytes, each byte-equal
                  to smooth_fastq, then block_smooth_fastq on 4 ranks
                  byte-equal to the pipeline's block route; (c) NCCL with one
                  rank per card where there are >= 2 cards (else a line says
                  why not); (d) --mesh with one rank more than the cards
                  exits non-zero naming both counts
 10. variant_proxy  utils/variant_proxy.run_proxy on the card: 2M x 101 bp
                  from a 6 Mb diploid genome with 2,500 planted
                  heterozygous SNPs (~34x, phase 5's 204M positions); the
                  device pileup equal to np.add.at's, the smoothed reads and
                  stats equal to a rerun with the plain scans on the card,
                  5 seg_scan launches, bases modified; then precision and
                  recall before and after, the largest alt-allele support
                  drop, non-SNP noise before and after and "preserved"
                  (the JAX test's checks, reported, not gated), step
                  seconds, peak device bytes
 11. profile      tools/profile_stages_torch.py on phase 5's reads: build /
                  smooth / invert ms (best of 3), then one smooth_step
                  under torch.profiler: top 10 device kernels, seg_scan's
                  5 launches (gated), device-busy ms and the idle share of
                  the call's wall span
 12. entry points the port's measurement tools and the BQZE codec on the
                  card: (a) bfqzip_tpu_torch.bench.run on phase 5's reads
                  (reps 3) and `python -m bfqzip_tpu_torch.bench` at its
                  default 200K reads in a subprocess, each line naming the
                  card with 5 seg_scan launches per smooth_step;
                  (b) tools/profile_build_torch.py on phase 5's reads: pack
                  / sort / post / LCP ms beside their bounds, their sum
                  against the whole build, a trace of one build; (c)
                  tools/profile_smooth_torch.py on phase 5's reads: each
                  smooth step's ms, seg_scan and kernel launches (5 scans
                  in the whole smooth, gated); (d)
                  tools/run_ext10m_torch.py on a FASTQ of phase 5's first
                  500K reads under --mem-gb 1 with --out, byte-equal to
                  smooth_fastq and within its budget; (e) phase 6's
                  smoothed DNA stream (200K reads) through
                  encode_dna_stream and decode_dna_stream on the card:
                  the input back, a container equal to the CPU's, MB/s of
                  each direction; then the phase's seconds
 13. tools        the seven microbenchmark and codec tools, each in a
                  subprocess at its default size: bench_prims_torch.py (its
                  blocked-prefix and expansion checks),
                  bench_prims2_torch.py (each scan candidate through
                  csrc/seg_scan.cu equal to its plain version, the
                  two-level scheme equal to the one-level sum, launches
                  counted), microbench_sort_torch.py,
                  exp_unstable_sort_torch.py (the invert sorts and the
                  scatter agree), exp_overlap_torch.py (each chunk's reads
                  equal smooth_fastq's, 5 launches per stage triple),
                  bench_cm_torch.py (one timed decode) and
                  bench_decode_scaling_torch.py at 50K reads (every decode
                  byte-equal; 1-8 threads measured where the host has the
                  cores); each tool names the card; unstable-sort
                  identities are printed, not gated; then the phase's
                  seconds
Then a JSON line describing each kernel (its times are the sums over phase
5's launches), the card's name and power limit, and last the result line
{"ok": true, "device": {...}}.  Imports nothing of jax or of the JAX package
bfqzip_tpu.

`python3 chip_smoke.py sharded` runs phases 1, 2 and 9 alone, and `python3
chip_smoke.py cards` phases 1, 2 and 9 (c) alone at 2M reads on a machine
with two or more cards; neither prints a kernels line or a result line.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time

# Expandable segments keep the caching allocator from fragmenting across
# phases: phase 9 (a) is sized a few GB under the card's memory, and after
# phases 5-8 it was refused with up to 27 GB reserved but unallocated.  Set
# before torch first touches the card; the ranks the script spawns inherit it.
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")
N_BENCH = 20_400_000  # 200K reads x 102 positions
N_MAIN = 204_000_000  # the main path's n_pad: 2M reads x 102 positions
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory, NVIDIA's data sheet
REAL_READS, REAL_LEN = 2_000_000, 101
# the host codecs encode ~2.8 MB/s over the three streams on the host of an
# NVIDIA H100 80GB HBM3 at 700 W (PERF.md), so their depth is cut
CODEC_READS = 200_000
LONG_READS, LONG_LEN = 300_000, 600  # 180.3M suffix positions
SA64_READS = 500_000
BIG_READS = 4_000_000  # 404M positions: the in-core engine would need ~80 GB
MERGE_BENCH_READS = 250_000  # 8 (e): 25.5M positions, so the one-thread merges stay short
SEG_CHECKED = 4  # the out-of-core segment held against the plain scans (of 10)
BUDGET_WIDTHS = (101, 151, 201, 251, 323, 330, 600, 1000)  # flat to 323 bp, then doubling
BUDGET_CHUNK_POS = 20_000_000  # positions per measured chunk sort
WIDE_READS, WIDE_LEN = 400_000, 250  # 100.4M positions under a 2 GiB budget
WORK = os.path.join(ROOT, "build", "chip_smoke")  # gitignored
# phase 9, the sequence-sharded pipeline
SHARD_PROBE_READS = 200_000  # (a) the world-1 run whose peak bytes per position size (a)
SHARD_PEAK_BYTES = 70e9  # (a)'s peak device bytes stay under this
SHARD_TARGET_BYTES = 64e9  # (a)'s read count is sized for this much, 6 GB under it
SHARD_RANKS = 4  # (b) ranks sharing the one card through a gloo group
SHARD_FLAT_READS = 200_000  # (b) flat body, block mode
SHARD_LONG_READS, SHARD_LONG_LEN = 30_000, 150  # (b) wp = 151 > 120: the doubling body
SHARD_RETRY_READS, SHARD_RETRY_FACTOR = 50_000, 0.5  # (b) a capacity that overflows first
# phase 10, the variant-preservation proxy: phase 5's 204M positions at the
# JAX tests' ~34x coverage, one planted SNP per 2.4 kb
PROXY_READS, PROXY_LEN, PROXY_GENOME, PROXY_SNPS = 2_000_000, 101, 6_000_000, 2_500
# phase 12: the reads of the FASTQ that tools/run_ext10m_torch.py smooths under 1 GiB
EXT_TOOL_READS = 500_000
# phase 13: (arguments, environment) of the tools run at other than their
# defaults: on the card's host the decode scaling took 57.5 s at its 100K
# reads (half keeps 20 blocks of 256K per stream), and bench_cm's decodes
# 4 x 2.2-3.9 s per stream, so it times one after its warm-up
TOOL_RUN = {"bench_cm": (["--reps", "1"], None),
            "bench_decode_scaling": ([], {"BENCH_READS": "50000"})}


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
    """nvcc builds the kernel and the host compiler the port's k-way merge,
    both at once."""
    from concurrent.futures import ThreadPoolExecutor

    from bfqzip_tpu_torch.utils import cuda_build, native

    t = time.time()
    with ThreadPoolExecutor(2) as pool:
        kernel, merge = pool.map(cuda_build.build, ("seg_scan", "extmerge"))
    cuda_build.load("seg_scan")  # the libraries the wrappers use
    native._merge_lib()
    ptxas = [ln for ln in kernel[1].splitlines() if "registers" in ln or "spill" in ln]
    phase("build", seconds=time.time() - t, ptxas=ptxas, extmerge=os.path.relpath(merge[0], ROOT))


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
    if dtype == torch.int64:  # values past 2^31, as the out-of-core coordinates
        lo, hi = {"add": (0, 2**33), "max": (-(2**40), 2**40), "or": (0, 2**62),
                  "keepleft": (-(2**63), 2**63 - 1)}[op]
    else:
        lo, hi = {"add": (0, 100), "max": (-1000, 1000), "or": (0, 2**31 - 1),
                  "keepleft": (-(2**31), 2**31 - 1)}[op]
    return torch.randint(lo, hi, shape, generator=gen, device="cuda", dtype=dtype)


def _check(got, want, case: str) -> float:
    """Bit-exact for integers, 1e-12 relative for float64; the max abs error."""
    import torch

    torch.cuda.synchronize()
    if got.dtype == torch.float64:
        err = (got - want).abs()
        rel = (err / want.abs().clamp_min(1e-300)).max().item()
        if rel > 1e-12:
            fail(f"kernel vs plain {case}: relative error {rel}")
        return err.max().item()
    if not torch.equal(got, want):
        fail(f"kernel vs plain {case}: not bit-exact")
    return 0.0


def plain_ops():
    """A LocalScanOps whose every scan is the plain version, also on the card."""
    from bfqzip_tpu_torch.ops.scan import LocalScanOps, seg_scan

    class PlainScanOps(LocalScanOps):
        def _scan(self, x, flag, op, init, reverse=False):
            if reverse:
                return seg_scan(x.flip(-1), flag.flip(0), op, init).flip(-1)
            return seg_scan(x, flag, op, init)

    return PlainScanOps()


def _bits(t):
    """t as integers, so that equality is bit-equality for float64 too."""
    import torch

    return t.view(torch.int64) if t.dtype == torch.float64 else t


def _kernel_twice(x, f, op, init, reverse, case: str):
    """The kernel's result, after a second launch on the same inputs gave
    the same bits (a fixed float64 order; no race in the look-back)."""
    import torch

    from bfqzip_tpu_torch.ops import cuda_scan

    got = cuda_scan.seg_scan(x, f, op, init, reverse)
    again = cuda_scan.seg_scan(x, f, op, init, reverse)
    torch.cuda.synchronize()
    if not torch.equal(_bits(got), _bits(again)):
        fail(f"kernel {case}: two launches on the same inputs differ")
    return got


def bound_ms(x) -> float:
    """The least time of one scan of x on the card: x and the flag row read
    once and the output written once, over 3.35 TB/s."""
    C = 1 if x.dim() == 1 else x.shape[0]
    return (2 * C * x.element_size() + 1) * x.shape[-1] / HBM_BYTES_PER_S * 1e3


def kernel_vs_plain() -> float:
    import torch

    from bfqzip_tpu_torch.ops import cuda_scan
    from bfqzip_tpu_torch.ops.scan import INT32_MIN, seg_scan

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    int64_min = torch.iinfo(torch.int64).min
    pairs = [("add", torch.int32, 0), ("max", torch.int32, INT32_MIN), ("or", torch.int32, 0),
             ("keepleft", torch.int32, 0), ("add", torch.int64, 0), ("max", torch.int64, int64_min),
             ("or", torch.int64, 0), ("keepleft", torch.int64, 0), ("add", torch.float64, 0.0)]
    plain = plain_ops()
    max_abs, cases, misaligned, carry_cases, timings = 0.0, 0, 0, 0, []
    for op, dtype, init in pairs:
        tile = cuda_scan.tile_size(dtype)
        # tile edges, the last past one look-back window of 32 tiles
        edges = [k * tile + d for k in (1, 33) for d in (-1, 0, 1)]
        for C in (1, 5):
            for reverse in (False, True):
                for n in (1, 127, 4097, 1_000_003, N_BENCH, *edges):
                    for pattern in ("none", "all", "dense", "first", "last"):
                        shape = (n,) if C == 1 else (C, n)
                        x = _values(op, dtype, shape, gen)
                        f = _flags(pattern, n, gen)
                        case = f"{op}/{dtype}/C={C}/rev={reverse}/n={n}/{pattern}"
                        got = _kernel_twice(x, f, op, init, reverse, case)
                        want = plain._scan(x, f, op, init, reverse)
                        max_abs = max(max_abs, _check(got, want, case))
                        cases += 1
                        misaligned += C > 1 and n * x.element_size() % 16 != 0
                        if n == N_BENCH and pattern == "dense":
                            timings.append({
                                "op": op, "dtype": str(dtype).split(".")[-1], "C": C,
                                "reverse": reverse, "n": n,
                                "ms": cuda_ms(lambda: cuda_scan.seg_scan(x, f, op, init, reverse), 20),
                                "plain_ms": cuda_ms(lambda: seg_scan(x, f, op, init), 3),
                                "bound_ms": bound_ms(x),
                            })
                        del x, f, got, want
                # a random per-channel carry as init, on the card, as the
                # out-of-core segments pass it
                for n in (1, 4097, 1_000_003):
                    for pattern in ("none", "dense"):
                        shape = (n,) if C == 1 else (C, n)
                        x = _values(op, dtype, shape, gen)
                        f = _flags(pattern, n, gen)
                        carry = _values(op, dtype, (C,), gen)
                        if C == 1 and n > 1:
                            carry = carry[0]  # a 0-d carry, as SeqChunkOps records one
                        case = f"carry {op}/{dtype}/C={C}/rev={reverse}/n={n}/{pattern}"
                        got = _kernel_twice(x, f, op, carry, reverse, case)
                        want = plain._scan(x, f, op, carry, reverse)
                        max_abs = max(max_abs, _check(got, want, case))
                        carry_cases += 1
    # look-back stress at the main path's size: one flag, at position 0, so
    # every tile's prefix runs back to the first tile
    stress = []
    for op, C, init in (("add", 5, 0), ("max", 1, INT32_MIN)):
        for reverse in (False, True):
            shape = (N_MAIN,) if C == 1 else (C, N_MAIN)
            x = _values(op, torch.int32, shape, gen)
            f = _flags("first", N_MAIN, gen)
            case = f"stress {op}/int32/C={C}/rev={reverse}/n={N_MAIN}/first"
            got = _kernel_twice(x, f, op, init, reverse, case)
            _check(got, plain._scan(x, f, op, init, reverse), case)
            stress.append(case)
            del x, f, got
    phase("kernel", cases=cases, misaligned_cases=misaligned, carry_cases=carry_cases,
          stress=stress, runs_bit_equal=True, max_abs_err=max_abs, timings=timings)
    return max_abs


def goldens() -> None:
    from bfqzip_tpu_torch import SmoothConfig
    from bfqzip_tpu_torch.engine import smooth_fastq
    from bfqzip_tpu_torch.io import format_fastq, read_fastq

    cfgs = {"m0b0": SmoothConfig(mode=0), "m1b0": SmoothConfig(mode=1), "m2b0": SmoothConfig(),
            "m3b0": SmoothConfig(mode=3), "m2b1": SmoothConfig(binning=True),
            "m2b0h": SmoothConfig()}
    done = []
    for ds in ("example", "example_r1", "synth_var", "synth_long"):
        batch = read_fastq(os.path.join(GOLDEN, f"{ds}.in.fastq"))
        for tag, cfg in cfgs.items():
            out, _ = smooth_fastq(batch, cfg, device="cuda")
            got = format_fastq(out) if tag == "m2b0h" else format_fastq(out, headers=None)
            with open(os.path.join(GOLDEN, f"{ds}.{tag}.fq"), "rb") as fh:
                if got != fh.read():
                    fail(f"golden {ds}.{tag} differs")
            done.append(f"{ds}.{tag}")
    if len(done) != 24:
        fail(f"{len(done)} goldens checked, expected 24")
    phase("goldens", byte_equal=len(done), names=done)


def real_batch(n_reads: int = REAL_READS, read_len: int = REAL_LEN):
    """Realistic reads from tools/make_realistic.py (4.6 Mb genome, seed 0),
    and the seconds taken to make them."""
    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from make_realistic import make

    from bfqzip_tpu_torch.io import ReadBatch, encode

    t = time.time()
    seq_ascii, quals = make(n_reads, read_len, 4.6, 0, 0.005, 0.001)
    batch = ReadBatch(seqs=encode(seq_ascii), quals=quals,
                      lengths=np.full(n_reads, read_len, np.int32))
    return batch, time.time() - t


def real_size(batch, t_data: float) -> dict:
    import numpy as np
    import torch

    from bfqzip_tpu_torch import SmoothConfig
    from bfqzip_tpu_torch.convert import batch_to_tensors
    from bfqzip_tpu_torch.engine import smooth_fastq
    from bfqzip_tpu_torch.ops import cuda_scan
    from bfqzip_tpu_torch.ops.invert import invert_via_sa
    from bfqzip_tpu_torch.ops.smooth import smooth
    from bfqzip_tpu_torch.ops.suffix import build_ebwt

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
    plain = smooth(ebwt, cfg, pre=ebwt.pre, ops=plain_ops())
    if not (torch.equal(plain.bwt_sub, sm.bwt_sub) and torch.equal(plain.qs, sm.qs)):
        fail("smooth with the kernel differs from smooth with the plain scans")
    if {k: int(v) for k, v in plain.stats.items()} != {k: int(v) for k, v in sm.stats.items()}:
        fail("smooth stats differ between kernel and plain scans")
    del plain, sm, ident

    launch_times = main_path_launches(ebwt, cfg)
    n_pad = ebwt.bwt.shape[0]
    del ebwt

    res = {
        "reads": REAL_READS, "read_len": REAL_LEN, "n_pad": n_pad, "data_s": t_data,
        "run_s": run_s, "bases_per_s": total_bases / min(run_s),
        "bases_per_s_median": total_bases / sorted(run_s)[1], **stage,
        "peak_bytes": peak, "launches_per_run": per_run, "launches": launches,
        "stats": stats, "identity": True, "kernel_vs_plain_smooth": True,
        "scan_launches": launch_times,
    }
    phase("real_size", **res)
    return res


def main_path_launches(ebwt, cfg) -> list:
    """Each seg_scan launch of one smooth() on phase 5's EBWT, on its own
    inputs: the kernel against the plain version (bit-exact), then the
    kernel's, the plain version's and one unsegmented PyTorch call's ms
    beside the bound.  torch.cumsum (torch.cummax for max) along the last
    axis is the library yardstick: no one PyTorch call computes a segmented
    scan, so the closest one computes an unsegmented one; the port never
    calls it.  `copy_ms` times a device copy of x (x read once, written
    once): the memory rate the card reaches in practice on these bytes."""
    from bfqzip_tpu_torch.ops.smooth import smooth

    with _ScanRecorder() as rec:
        smooth(ebwt, cfg, pre=ebwt.pre)
    return time_launches(rec.calls, library=True)


class _ScanRecorder:
    """While active, every seg_scan kernel call keeps its inputs (copied to
    the host with `to_host`, so that a run near the card's memory is not
    pushed over it) in `calls`."""

    def __init__(self, to_host: bool = False):
        from bfqzip_tpu_torch.ops import cuda_scan

        self.cuda_scan, self.kernel, self.to_host, self.calls = cuda_scan, cuda_scan.seg_scan, to_host, []

    def __enter__(self):
        def recording(x, flag, op, init, reverse=False):
            keep = (x, flag, op, init, reverse)
            if self.to_host:
                keep = _map_tensors(keep, lambda t: t.cpu())
            self.calls.append(keep)
            return self.kernel(x, flag, op, init, reverse)

        self.cuda_scan.seg_scan = recording
        return self

    def __exit__(self, *exc):
        self.cuda_scan.seg_scan = self.kernel
        return False


def time_launches(calls, library: bool) -> list:
    """Each recorded seg_scan call on the card: the kernel against the plain
    version (bit-exact), its ms, the plain version's ms and the bound; with
    `library`, also the ms of one unsegmented PyTorch call (see
    main_path_launches) and of a device copy of x."""
    import torch

    from bfqzip_tpu_torch.ops import cuda_scan

    kernel = cuda_scan.seg_scan
    plain = plain_ops()
    out = []
    while calls:
        x, f, op, init, reverse = _map_tensors(calls.pop(0), lambda t: t.cuda())
        case = f"main-path {op}/{x.dtype}/{tuple(x.shape)}/rev={reverse}"
        _check(kernel(x, f, op, init, reverse), plain._scan(x, f, op, init, reverse), case)
        ms = cuda_ms(lambda: kernel(x, f, op, init, reverse), 20)
        row = {"op": op, "dtype": str(x.dtype).split(".")[-1], "shape": list(x.shape),
               "reverse": reverse, "flags": int(f.sum()), "ms": ms,
               "plain_ms": cuda_ms(lambda: plain._scan(x, f, op, init, reverse), 2),
               "bound_ms": bound_ms(x), "bound_share": bound_ms(x) / ms}
        if library:
            if op == "max":
                call = lambda: torch.cummax(x, dim=-1)  # noqa: E731
            else:
                call = lambda: torch.cumsum(x, dim=-1, dtype=x.dtype)  # noqa: E731
            copy = torch.empty_like(x)
            row.update(library_ms=cuda_ms(call, 10),
                       library_call="torch.cummax" if op == "max" else "torch.cumsum",
                       copy_ms=cuda_ms(lambda: copy.copy_(x), 20))
            del copy
        out.append(row)
        del x, f
    return out


def _cli(argv, reports=None) -> float:
    """bfqzip_tpu_torch.cli.main(argv) on the card; its seconds.  The
    pipeline's report (sizes, per-phase seconds and device bytes) of a
    compress run is appended to `reports`."""
    import torch

    from bfqzip_tpu_torch import cli, pipeline

    run = pipeline.run_pipeline

    def recording(*a, **k):
        res = run(*a, **k)
        reports.append(res.report)
        return res

    if reports is not None:
        pipeline.run_pipeline = recording
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
    finally:
        pipeline.run_pipeline = run
    if rc != 0:
        fail(f"bfqzip_tpu_torch {' '.join(argv)} exited {rc}")
    return dt


def _phases(report) -> list:
    return [{"phase": p["phase"], "seconds": p["seconds"],
             "peak_bytes": p.get("peak_bytes_in_use")} for p in report["phases"]]


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def cli_path(batch, native_make) -> dict:
    """Phase 6: the CLI at 2M reads, step 3 first on step 1's arrays and
    then through the cached artifacts, and the codec path (compress,
    restore, decompress) at 200K reads."""
    import torch

    from bfqzip_tpu_torch import SmoothConfig
    from bfqzip_tpu_torch.engine import smooth_fastq
    from bfqzip_tpu_torch.io import ReadBatch, format_fastq
    from bfqzip_tpu_torch.ops import cuda_scan, rans
    from bfqzip_tpu_torch.ops.invert import invert
    from bfqzip_tpu_torch.ops.rank import lf_array
    from bfqzip_tpu_torch.ops.smooth import smooth
    from bfqzip_tpu_torch.ops.suffix import EbwtDevice
    from bfqzip_tpu_torch.pipeline import load_artifacts

    rc, make_log, make_s = native_make
    if rc != 0 or not rans.native_available():
        fail(f"native codec library unavailable (make -C native exited {rc}):\n{make_log[-3000:]}")

    os.makedirs(WORK, exist_ok=True)
    headers = [b"@r%d" % i for i in range(batch.num_reads)]
    t = time.time()
    inp = os.path.join(WORK, "real.fastq")
    with open(inp, "wb") as f:
        f.write(format_fastq(ReadBatch(seqs=batch.seqs, quals=batch.quals,
                                       lengths=batch.lengths, headers=headers)))
    write_s = time.time() - t

    # steps 1-3 at full size through the artifacts; mode 0 skips the codecs
    out = os.path.join(WORK, "real")
    reports = []
    cuda_scan.launches = 0
    cli_s = _cli([inp, "-o", out, "-0", "--rebuild"], reports)
    launches = [cuda_scan.launches]
    if launches[0] < 6:
        fail(f"seg_scan launched {launches[0]} times in the CLI run, expected >= 6 "
             "(smooth's 5 + lf_array's 1; step 1 runs no scan)")
    fq = _read(out + ".fq")
    ref, _ = smooth_fastq(batch, SmoothConfig(), device="cuda")
    if fq != format_fastq(ref, headers=None):
        fail("CLI .fq (LF-walk path) differs from smooth_fastq (SA path) at 2M reads")
    del ref

    # the cached run skips step 1 and writes the same bytes
    bwt_mtime = os.stat(out + ".bwt").st_mtime_ns
    cuda_scan.launches = 0
    cached_s = _cli([inp, "-o", out, "-0"], reports)
    launches.append(cuda_scan.launches)
    if os.stat(out + ".bwt").st_mtime_ns != bwt_mtime or any(
            p["phase"].startswith("step1") for p in reports[1]["phases"]):
        fail("the second CLI run did not reuse the step-1 artifacts")
    if _read(out + ".fq") != fq:
        fail("the cached CLI run wrote other bytes")
    if [r.get("step3_input") for r in reports] != ["held", "files"]:
        fail("step 3 took its input from "
             f"{[r.get('step3_input') for r in reports]}, expected step 1's arrays, then the files")
    del fq

    # step 3's parts on the artifacts, each timed alone
    (bwt, qs, lcp, n_t), meta = load_artifacts(out, "cuda")
    stage = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        stage[name] = (time.perf_counter() - t0) * 1e3
        return r

    valid = torch.arange(bwt.shape[0], dtype=torch.int32, device=bwt.device) < n_t
    lf = timed("lf_array_ms", lambda: lf_array(bwt, valid))
    sm = timed("smooth_ms", lambda: smooth(EbwtDevice(bwt, qs, lcp, None, None, n_t),
                                           SmoothConfig(), pre=bwt[lf]))
    timed("lf_walk_invert_ms", lambda: invert(bwt, sm.bwt_sub, sm.qs, lf,
                                              meta["n_reads"], meta["max_len"]))
    del bwt, qs, lcp, lf, sm, valid

    # the codec path at 200K reads: --m3, --restore, --decompress
    k = CODEC_READS
    small = ReadBatch(seqs=batch.seqs[:k], quals=batch.quals[:k], lengths=batch.lengths[:k],
                      headers=headers[:k])
    inp2, out2 = os.path.join(WORK, "small.fastq"), os.path.join(WORK, "small")
    with open(inp2, "wb") as f:
        f.write(format_fastq(small))
    cuda_scan.launches = 0
    m3_s = _cli([inp2, "-o", out2, "--m3", "--rebuild"], reports)
    launches.append(cuda_scan.launches)
    ref, _ = smooth_fastq(small, SmoothConfig(), device="cuda")
    if _read(out2 + ".fq") != format_fastq(ref):
        fail("--m3 .fq differs from smooth_fastq at 200K reads")
    streams = [out2 + s for s in (".fq.dna", ".fq.qs", ".h")]
    stream_bytes = sum(os.path.getsize(s) for s in streams)
    archive_bytes = sum(os.path.getsize(s + ".rans") for s in streams)
    step5 = [p for p in reports[2]["phases"] if p["phase"].startswith("step5")]
    restore_s = _cli(["--restore", out2, "-o", out2 + ".restored.fastq"])
    if _read(out2 + ".restored.fastq") != _read(out2 + ".fq"):
        fail("--restore differs from the compressed .fq")
    decode_s = 0.0
    for s in streams:
        decode_s += _cli(["--decompress", s + ".rans", "-o", s + ".dec"])
        if _read(s + ".dec") != _read(s):
            fail(f"--decompress of {os.path.basename(s)}.rans differs from the stream")

    res = {
        "native_make_s": make_s, "fastq_write_s": write_s, "reads": batch.num_reads,
        "cli_s": cli_s, "cached_cli_s": cached_s, "launches_per_run": launches,
        "launches": sum(launches), "byte_equal_to_smooth_fastq": True, "cache_reused": True,
        "phases": _phases(reports[0]), "cached_phases": _phases(reports[1]), **stage,
        "codec_reads": k, "m3_s": m3_s, "m3_phases": _phases(reports[2]),
        "stream_bytes": stream_bytes, "archive_bytes": archive_bytes,
        "encode_mb_s": stream_bytes / 1e6 / step5[0]["seconds"],
        "restore_mb_s": os.path.getsize(out2 + ".fq") / 1e6 / restore_s,
        "decode_mb_s": stream_bytes / 1e6 / decode_s, "restored_byte_equal": True,
    }
    phase("cli", **res)
    return res


def long_reads() -> dict:
    """Phase 7: 300K x 600 bp through smooth_fastq on the doubling build."""
    import numpy as np
    import torch

    from bfqzip_tpu_torch import SmoothConfig
    from bfqzip_tpu_torch.convert import batch_to_tensors
    from bfqzip_tpu_torch.engine import pre_of, smooth_fastq
    from bfqzip_tpu_torch.ops import cuda_scan
    from bfqzip_tpu_torch.ops.invert import invert_via_sa
    from bfqzip_tpu_torch.ops.smooth import smooth
    from bfqzip_tpu_torch.ops.suffix import build_ebwt, build_route

    if build_route(LONG_LEN) != "doubling":
        fail("the long-read phase must take the doubling build")
    batch, t_data = real_batch(LONG_READS, LONG_LEN)
    cfg = SmoothConfig()
    smooth_fastq(batch, cfg, device="cuda")  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    cuda_scan.launches = 0
    t = time.perf_counter()
    out, stats = smooth_fastq(batch, cfg, device="cuda")
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t
    launches = cuda_scan.launches
    peak = torch.cuda.max_memory_allocated()
    if launches < 5:
        fail(f"seg_scan launched {launches} times in the long-read smooth_fastq, expected >= 5")
    if out.seqs.shape != batch.seqs.shape or not np.array_equal(out.lengths, batch.lengths):
        fail("long-read output has the wrong shape or read lengths")
    changed = int((out.seqs != batch.seqs).sum())
    if changed != stats["modified"] or stats["num_clust"] == 0:
        fail(f"long reads: {changed} bases changed for modified={stats['modified']}")

    seqs, qs_in, lengths = batch_to_tensors(batch, "cuda")
    stage = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        stage[name] = (time.perf_counter() - t0) * 1e3
        return r

    ebwt = timed("build_ms", lambda: build_ebwt(seqs, qs_in, lengths))
    if ebwt.pre is not None:
        fail("the doubling build carries no pre")
    pre = pre_of(ebwt)
    sm = timed("smooth_ms", lambda: smooth(ebwt, cfg, pre=pre))
    timed("invert_ms", lambda: invert_via_sa(ebwt.sa, ebwt.bwt, sm.bwt_sub, sm.qs, ebwt.n,
                                             LONG_READS, LONG_LEN))
    ident = invert_via_sa(ebwt.sa, ebwt.bwt, ebwt.bwt, ebwt.qs, ebwt.n, LONG_READS, LONG_LEN)
    if not (torch.equal(ident.seqs, seqs) and torch.equal(ident.quals, qs_in)
            and torch.equal(ident.lengths, lengths)):
        fail("long reads: identity round trip differs from the input")
    del ident
    plain = smooth(ebwt, cfg, pre=pre, ops=plain_ops())
    if not (torch.equal(plain.bwt_sub, sm.bwt_sub) and torch.equal(plain.qs, sm.qs)):
        fail("long reads: smooth with the kernel differs from smooth with the plain scans")
    if {k: int(v) for k, v in plain.stats.items()} != {k: int(v) for k, v in sm.stats.items()}:
        fail("long reads: smooth stats differ between kernel and plain scans")
    n_pad = ebwt.bwt.shape[0]
    del plain, sm, ebwt, pre, seqs, qs_in, lengths
    res = {"reads": LONG_READS, "read_len": LONG_LEN, "n_pad": n_pad, "data_s": t_data,
           "run_s": run_s, "bases_per_s": LONG_READS * LONG_LEN / run_s, **stage,
           "peak_bytes": peak, "launches": launches, "changed": changed, "stats": stats,
           "identity": True, "kernel_vs_plain_smooth": True}
    phase("long_reads", **res)
    if peak > 70e9:
        fail(f"long-read peak {peak} bytes passes 70 GB: cut LONG_READS")
    return res


def _map_tensors(obj, fn):
    """obj with fn applied to every tensor inside its tuples, lists and dicts."""
    import torch

    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(_map_tensors(o, fn) for o in obj)
    if isinstance(obj, dict):
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    return obj


def _flat_tensors(obj, path="out"):
    """(path, tensor) pairs of every tensor inside obj."""
    import torch

    if isinstance(obj, torch.Tensor):
        return [(path, obj)]
    if isinstance(obj, (list, tuple)):
        return [p for i, o in enumerate(obj) for p in _flat_tensors(o, f"{path}[{i}]")]
    if isinstance(obj, dict):
        return [p for k, v in obj.items() for p in _flat_tensors(v, f"{path}[{k}]")]
    return []


class _SegmentCheck:
    """One segment of an out-of-core run held against the plain scans: while
    active, the call number `index` of external._part1_segment keeps its
    inputs (window, base, carries in) and its kernel outputs (packed words,
    stats, carries out, ...) on the host; check() reruns that segment on the
    card with every scan the plain version and requires each output equal."""

    def __init__(self, index: int):
        from bfqzip_tpu_torch import external

        self.external, self.index, self.calls, self.record = external, index, 0, None
        self._part1 = external._part1_segment

    def __enter__(self):
        def recording(*args, **kwargs):
            out = self._part1(*args, **kwargs)
            if self.calls == self.index:
                self.record = _map_tensors((args, kwargs, out), lambda t: t.cpu())
            self.calls += 1
            return out

        self.external._part1_segment = recording
        return self

    def __exit__(self, *exc):
        self.external._part1_segment = self._part1
        return False

    def check(self, what: str) -> dict:
        import torch

        if self.record is None or self.index >= self.calls - 1:
            fail(f"{what}: segment {self.index} of {self.calls} is not a middle segment")
        args, kwargs, want = _map_tensors(self.record, lambda t: t.cuda())
        got = _flat_tensors(self._part1(*args, **kwargs, scans=plain_ops()))
        want = _flat_tensors(want)
        if [p for p, _ in got] != [p for p, _ in want]:
            fail(f"{what}: the plain-scan segment returned other outputs")
        for (path, g), (_, w) in zip(got, want):
            if g.dtype != w.dtype or not torch.equal(g, w):
                fail(f"{what}: segment {self.index}, {path} differs between kernel and plain scans")
        return {"segment": self.index, "of": self.calls, "window": int(args[0].shape[0]),
                "carries_in": len(args[5]), "outputs_equal": len(want)}


def external_path(real) -> dict:
    """Phase 8: the out-of-core path, (a) through the CLI, (b) with int64
    coordinates, (c) at a size one card cannot hold in memory, (d) the
    device budget across read widths."""
    import numpy as np
    import torch

    from bfqzip_tpu_torch.io.spill import Spill
    from bfqzip_tpu_torch import SmoothConfig
    from bfqzip_tpu_torch.external import smooth_fastq_external
    from bfqzip_tpu_torch.ops import cuda_scan
    from bfqzip_tpu_torch.utils.profiling import RssSampler

    cfg = SmoothConfig()
    res = {}

    # (a) the CLI on phase 6's FASTQ, against phase 6's in-core .fq
    budget_mb = 4096
    reports = []
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    cuda_scan.launches = 0
    out = os.path.join(WORK, "real_ext")
    with _SegmentCheck(SEG_CHECKED) as seg_a:
        cli_s = _cli([os.path.join(WORK, "real.fastq"), "-o", out, "-0", "--ext-mem",
                      "--mem", str(budget_mb)], reports)
    launches_a = cuda_scan.launches
    rep = reports[0]["external"]
    step = [p for p in reports[0]["phases"] if p["phase"].startswith("steps1-3")][0]
    peak_a = step["peak_bytes_in_use"] - base_bytes
    if _read(out + ".fq") != _read(os.path.join(WORK, "real.fq")):
        fail("--ext-mem .fq differs from the in-core CLI's .fq at 2M reads")
    if not rep["overlap"]:
        fail("--ext-mem ran the serial merge; the merge || smooth overlap is the default")
    if rep["n_chunks"] < 8 or rep["n_segments"] < 4:
        fail(f"--ext-mem ran {rep['n_chunks']} chunks and {rep['n_segments']} segments, "
             "expected >= 8 and >= 4")
    if peak_a > budget_mb << 20:
        fail(f"--ext-mem peak device bytes {peak_a} exceed the {budget_mb} MB budget")
    if launches_a < 5 * rep["n_segments"]:
        fail(f"seg_scan launched {launches_a} times over {rep['n_segments']} segments")
    res["cli"] = {"reads": real["reads"], "budget_bytes": budget_mb << 20, "seconds": cli_s,
                  "peak_device_bytes": peak_a, "launches": launches_a, "report": rep,
                  "phases": _phases(reports[0]), "byte_equal_to_in_core": True,
                  "segment_vs_plain": seg_a.check("--ext-mem at 2M reads")}

    # (b) int64 coordinates against the int32 route
    batch, _ = real_batch(SA64_READS, REAL_LEN)
    mem = 1 << 30
    routes = {}
    for wide in (False, True):
        os.environ["BFQ_EXT_SA64"] = "1" if wide else "0"
        cuda_scan.launches_by_dtype.clear()
        cuda_scan.launches = 0
        routes[wide] = smooth_fastq_external(batch, cfg, mem, device="cuda") + (
            cuda_scan.launches, dict(cuda_scan.launches_by_dtype))
    os.environ.pop("BFQ_EXT_SA64")
    (o32, s32, _, _), (o64, s64, launches_b, by_dtype) = routes[False], routes[True]
    if not (np.array_equal(o32.seqs, o64.seqs) and np.array_equal(o32.quals, o64.quals)
            and s32 == s64):
        fail("BFQ_EXT_SA64=1 output or stats differ from the int32 route")
    if by_dtype.get("int64", 0) == 0:
        fail("the int64 route launched no int64 seg_scan")
    res["sa64"] = {"reads": SA64_READS, "byte_equal": True, "launches": launches_b,
                   "launches_by_dtype": by_dtype}
    del batch, routes, o32, o64

    # (c) 404M positions under an 8 GiB budget, with spill files: the merge
    # overlapped with smoothing (the default), serial, and overlapped on two
    # threads fewer than the cores this process may use
    batch, t_data = real_batch(BIG_READS, REAL_LEN)
    cores = len(os.sched_getaffinity(0))
    runs = {
        "overlap": _big_run(batch, cfg, {"BFQ_EXT_OVERLAP": "1", "BFQ_EXT_THREADS": None}, True),
        "serial": _big_run(batch, cfg, {"BFQ_EXT_OVERLAP": "0", "BFQ_EXT_THREADS": None}, False),
        f"overlap_{cores - 2}_threads": _big_run(
            batch, cfg, {"BFQ_EXT_OVERLAP": "1", "BFQ_EXT_THREADS": str(cores - 2)}, False),
    }
    if len({(r["digest"], json.dumps(r["stats"], sort_keys=True)) for r in runs.values()}) != 1:
        fail(f"out-of-core at {BIG_READS} reads: the runs differ: "
             f"{ {k: (r['digest'], r['stats']) for k, r in runs.items()} }")
    res["big"] = {"reads": BIG_READS, "n_pad": BIG_READS * (REAL_LEN + 1), "data_s": t_data,
                  "cpu_count": os.cpu_count(), "cpu_affinity": cores, "byte_equal": True, **runs}
    launches_c = sum(r["launches"] for r in runs.values())
    del batch
    res["budget"] = budget_by_width(cfg)
    res["launches"] = launches_a + launches_b + launches_c + res["budget"]["launches"]
    phase("external", **res)
    res["bench"] = merge_bench()
    return res


@contextlib.contextmanager
def _environ(env: dict):
    """The environment variables `env` set for the block (None: unset)."""
    saved = {k: os.environ.get(k) for k in env}

    def apply(values):
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    apply(env)
    try:
        yield
    finally:
        apply(saved)


def _big_run(batch, cfg, env: dict, check_segment: bool) -> dict:
    """One run of phase 8 (c) with `env` set (None unsets a variable):
    seconds, bases/s, stage seconds (merge_wait_s: smoothing blocked on the
    merged prefix), peak device bytes within the budget, peak host RSS, the
    prefix curve, launches, and a digest of the smoothed reads taken before
    the spill files close; with check_segment, one middle segment rerun with
    the plain scans."""
    import hashlib

    import numpy as np
    import torch

    from bfqzip_tpu_torch.external import smooth_fastq_external
    from bfqzip_tpu_torch.io.spill import Spill
    from bfqzip_tpu_torch.ops import cuda_scan
    from bfqzip_tpu_torch.utils.profiling import RssSampler

    mem = 8 << 30
    os.makedirs(WORK, exist_ok=True)
    sp = Spill(dir=WORK)
    free_disk = shutil.disk_usage(sp.dir).free
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cuda_scan.launches = 0
    rep = {}
    seg = _SegmentCheck(SEG_CHECKED) if check_segment else None
    t = time.perf_counter()
    try:
        with _environ(env), RssSampler() as rss, seg or contextlib.nullcontext():
            out, stats = smooth_fastq_external(batch, cfg, mem, device="cuda", spill=sp, report=rep)
        seconds = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated() - base_bytes
        launches = cuda_scan.launches
        digest, changed, slab = hashlib.sha256(), 0, 1 << 20
        for lo in range(0, batch.num_reads, slab):
            seqs, quals = np.asarray(out.seqs[lo:lo + slab]), np.asarray(out.quals[lo:lo + slab])
            digest.update(seqs.tobytes())
            digest.update(quals.tobytes())
            changed += int((seqs != batch.seqs[lo:lo + slab]).sum())
        spilled = isinstance(out.seqs, np.memmap)
        del out
    finally:
        sp.close()
    what = f"out-of-core at {BIG_READS} reads with {env}"
    if changed != stats["modified"] or stats["num_clust"] == 0:
        fail(f"{what}: {changed} bases changed for modified={stats['modified']}")
    if peak > mem:
        fail(f"{what}: peak device bytes {peak} exceed the {mem}-byte budget")
    if launches < 5 * rep["n_segments"]:
        fail(f"{what}: seg_scan launched {launches} times over {rep['n_segments']} segments")
    if rep["overlap"] != (env["BFQ_EXT_OVERLAP"] == "1"):
        fail(f"{what}: the report says overlap={rep['overlap']}")
    res = {"env": env, "budget_bytes": mem, "seconds": seconds, "peak_device_bytes": peak,
           "bases_per_s": BIG_READS * REAL_LEN / seconds,
           "stages_s": {k: rep.get(k) for k in ("chunk_sorts_s", "merge_s", "merge_wait_s", "smooth_s",
                                                "emit_s")},
           "prefix_s": rep.get("merge_prefix_s"), "report": rep,
           "rss_before_bytes": rss.start, "peak_rss_bytes": rss.peak,
           "spilled": spilled, "spill_free_disk": free_disk,
           "launches": launches, "launches_per_segment": launches / rep["n_segments"],
           "changed": changed, "stats": stats, "digest": digest.hexdigest()}
    if seg is not None:
        res["segment_record_bytes"] = sum(t.nbytes for _, t in _flat_tensors(seg.record))
        res["segment_vs_plain"] = seg.check(what)
    phase("external_big", **{k: v for k, v in res.items() if k != "report"})
    return res


def merge_bench() -> dict:
    """Phase 8 (e): tools/bench_extmerge_torch.py on the first MERGE_BENCH_READS
    reads of phase 6's FASTQ: the port's merge threaded and on one thread,
    with and without chunk LCPs (all equal), and the live merge's prefix
    curve with one range per thread and with eight."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import bench_extmerge_torch

    res = bench_extmerge_torch.run(os.path.join(WORK, "real.fastq"), MERGE_BENCH_READS, 16, 0, "cuda")
    _names_card(res, "bench_extmerge_torch")
    if not res["all_equal"] or set(res["live"]) != {"one_range_per_thread", "eight_ranges_per_thread"}:
        fail(f"bench_extmerge_torch: {res}")
    phase("external_merge_bench", **res)
    return res


def budget_by_width(cfg) -> dict:
    """Phase 8 (d): the device budget across read widths.  A chunk sort's
    peak per position stays within the bytes per position that size the
    chunks, at every width; then a whole out-of-core run at WIDE_LEN bp
    stays within its budget and writes the in-core engine's bytes."""
    import numpy as np
    import torch

    from bfqzip_tpu_torch import external
    from bfqzip_tpu_torch.engine import smooth_fastq
    from bfqzip_tpu_torch.io import ReadBatch
    from bfqzip_tpu_torch.ops import cuda_scan
    from bfqzip_tpu_torch.ops.suffix import build_route

    rng = np.random.default_rng(1)
    sorts = []
    for width in BUDGET_WIDTHS:  # the build's memory does not depend on the bases
        n_reads = BUDGET_CHUNK_POS // (width + 1)
        b = ReadBatch(seqs=rng.integers(0, 4, (n_reads, width), dtype=np.uint8),
                      quals=rng.integers(33, 75, (n_reads, width), dtype=np.uint8),
                      lengths=np.full(n_reads, width, np.int32))
        torch.cuda.synchronize()
        base_bytes = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        external._sort_chunk(b, 0, n_reads, torch.device("cuda"))
        torch.cuda.synchronize()
        n_pad = n_reads * (width + 1)
        per_pos = (torch.cuda.max_memory_allocated() - base_bytes) / n_pad
        allowed = external._build_bytes_per_pos(width)
        sorts.append({"width": width, "route": build_route(width), "n_pad": n_pad,
                      "bytes_per_pos": per_pos, "allowed": allowed,
                      "ms": (time.perf_counter() - t) * 1e3})
        if per_pos > allowed:
            fail(f"a chunk sort at {width} bp takes {per_pos:.1f} B/pos, "
                 f"above the {allowed} that size its chunks")
        del b

    batch, t_data = real_batch(WIDE_READS, WIDE_LEN)
    mem = 2 << 30
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cuda_scan.launches = 0
    rep = {}
    t = time.perf_counter()
    with _SegmentCheck(SEG_CHECKED) as seg:
        out, stats = external.smooth_fastq_external(batch, cfg, mem, device="cuda", spill=False,
                                                    report=rep)
    seconds = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() - base_bytes
    launches = cuda_scan.launches
    if peak > mem:
        fail(f"out-of-core at {WIDE_LEN} bp: peak device bytes {peak} exceed the {mem}-byte budget")
    if rep["n_chunks"] < 8 or launches < 5 * rep["n_segments"]:
        fail(f"out-of-core at {WIDE_LEN} bp: {rep['n_chunks']} chunks, {launches} seg_scan "
             f"launches over {rep['n_segments']} segments")
    ref, ref_stats = smooth_fastq(batch, cfg, device="cuda")
    w = ref.max_len
    if not (np.array_equal(out.seqs[:, :w], ref.seqs) and np.array_equal(out.quals[:, :w], ref.quals)
            and stats == ref_stats):
        fail(f"out-of-core at {WIDE_LEN} bp differs from the in-core engine")
    res = {"chunk_sorts": sorts, "reads": WIDE_READS, "read_len": WIDE_LEN, "data_s": t_data,
           "budget_bytes": mem, "seconds": seconds, "peak_device_bytes": peak, "report": rep,
           "launches": launches, "byte_equal_to_in_core": True,
           "segment_vs_plain": seg.check(f"out-of-core at {WIDE_LEN} bp")}
    return res


def _same_reads(got, want) -> bool:
    """Equal lengths, and equal bases and qualities up to each read's length
    (the sharded path returns the raw width)."""
    import numpy as np

    w = int(want.lengths.max())
    return (np.array_equal(got.lengths, want.lengths) and np.array_equal(got.seqs[:, :w], want.seqs[:, :w])
            and np.array_equal(got.quals[:, :w], want.quals[:, :w]))


def _prefix(batch, k: int):
    from bfqzip_tpu_torch.io import ReadBatch

    return ReadBatch(seqs=batch.seqs[:k], quals=batch.quals[:k], lengths=batch.lengths[:k])


def _rank_stages(reports) -> dict:
    """Each stage's ms and peak device bytes on the rank where it is largest."""
    keys = [k for k in reports[0] if k.endswith(("_ms", "_peak_bytes"))]
    return {k: max(r[k] for r in reports) for k in keys}


def sharded_world1(batch) -> dict:
    """Phase 9 (a): smooth_fastq_sharded as the one rank of an NCCL group on
    the card, at the largest read count (<= 2M) whose peak stays under
    SHARD_PEAK_BYTES, sized from the peak bytes per position of a
    SHARD_PROBE_READS run."""
    import torch
    import torch.distributed as dist

    from bfqzip_tpu_torch import SmoothConfig
    from bfqzip_tpu_torch.engine import smooth_fastq
    from bfqzip_tpu_torch.ops import cuda_scan
    from bfqzip_tpu_torch.parallel import mesh, smooth_fastq_sharded

    cfg = SmoothConfig()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()  # earlier phases' cached blocks would fragment this one's
    store = os.path.join(WORK, f"nccl_world1_{os.getpid()}")
    comm = mesh.init_group(0, 1, "cuda", store)
    try:
        def run(b, reports=None):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out, stats = smooth_fastq_sharded(b, cfg, comm=comm, reports=reports)
            torch.cuda.synchronize()
            return out, stats, time.perf_counter() - t

        def peak_of(reports):  # a report resets the peak at each stage and records it
            return max(v for r in reports for k, v in r.items() if k.endswith("_peak_bytes"))

        probe = _prefix(batch, SHARD_PROBE_READS)
        run(probe)  # warm-up: NCCL's first collectives
        base_bytes = torch.cuda.memory_allocated()
        reports = []
        out, stats, _ = run(probe, reports)
        probe_bpp = (peak_of(reports) - base_bytes) / (SHARD_PROBE_READS * (REAL_LEN + 1))
        want, want_stats = smooth_fastq(probe, cfg, device="cuda")
        if not _same_reads(out, want) or stats != want_stats:
            fail(f"sharded world 1 at {SHARD_PROBE_READS} reads differs from smooth_fastq")
        count = min(REAL_READS, int(SHARD_TARGET_BYTES / probe_bpp / (REAL_LEN + 1)))
        sub = _prefix(batch, count)
        want, want_stats = smooth_fastq(sub, cfg, device="cuda")
        torch.cuda.empty_cache()
        run(sub)  # warm-up at this size
        torch.cuda.synchronize()
        base_bytes = torch.cuda.memory_allocated()
        run_s, launches, reports = [], [], []
        for _ in range(3):
            cuda_scan.launches = 0
            out, stats, sec = run(sub, reports)
            launches.append(cuda_scan.launches)
            run_s.append(sec)
        peak = peak_of(reports) - base_bytes
        if not _same_reads(out, want) or stats != want_stats:
            fail(f"sharded world 1 at {count} reads differs from smooth_fastq")
        if peak > SHARD_PEAK_BYTES:
            fail(f"sharded world 1 at {count} reads: peak {peak} bytes passes {SHARD_PEAK_BYTES}")
        if min(launches) < 5:
            fail(f"seg_scan launched {launches} times per sharded call, expected >= 5")
        # each seg_scan launch of one more call, on its own inputs at the
        # rank's shapes, against the plain version and the bound
        with _ScanRecorder(to_host=True) as rec:
            run(sub)
        scans = time_launches(rec.calls, library=False)
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)
    rep = reports[-1]
    res = {"backend": "nccl", "ranks": 1, "probe_reads": SHARD_PROBE_READS,
           "probe_bytes_per_pos": probe_bpp, "reads": count, "n_pad": count * (REAL_LEN + 1),
           "run_s": run_s, "best_s": min(run_s), "median_s": sorted(run_s)[1],
           "bases_per_s": count * REAL_LEN / min(run_s), "peak_bytes": peak,
           "bytes_per_pos": peak / (count * (REAL_LEN + 1)), "launches_per_call": launches,
           "stages": _rank_stages([rep]), "collective_bytes": rep["sent_bytes"],
           "staged_bytes": rep["staged_bytes"], "attempts": rep["attempts"],
           "byte_equal_to_smooth_fastq": True, "stats": stats, "scan_launches": scans}
    phase("sharded_world1", **res)
    return res


def sharded_ranks(batch) -> dict:
    """Phase 9 (b): SHARD_RANKS spawned ranks sharing the one card through a
    gloo group (each collective staged through the host): the flat body,
    the doubling body and a forced overflow, each byte-equal to
    smooth_fastq; then block_smooth_fastq on as many ranks, byte-equal to
    the pipeline's sequential block route."""
    import torch

    from bfqzip_tpu_torch import SmoothConfig
    from bfqzip_tpu_torch.config import PipelineConfig
    from bfqzip_tpu_torch.engine import smooth_fastq
    from bfqzip_tpu_torch.io import ReadBatch, format_fastq, read_fastq
    from bfqzip_tpu_torch.parallel import block_smooth_fastq, smooth_fastq_sharded
    from bfqzip_tpu_torch.pipeline import run_pipeline

    cfg = SmoothConfig()
    long_batch, _ = real_batch(SHARD_LONG_READS, SHARD_LONG_LEN)
    cases = {"flat": (_prefix(batch, SHARD_FLAT_READS), 2.5),
             "doubling": (long_batch, 2.5),
             "retry": (_prefix(batch, SHARD_RETRY_READS), SHARD_RETRY_FACTOR)}
    res = {}
    for name, (b, factor) in cases.items():
        want, want_stats = smooth_fastq(b, cfg, device="cuda")
        reports = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        got, stats = smooth_fastq_sharded(b, cfg, shards=SHARD_RANKS, device="cuda", backend="gloo",
                                          capacity_factor=factor, work_dir=WORK, reports=reports)
        seconds = time.perf_counter() - t
        if not _same_reads(got, want) or stats != want_stats:
            fail(f"sharded over {SHARD_RANKS} gloo ranks ({name}) differs from smooth_fastq")
        attempts = reports[0]["attempts"]
        if name == "retry" and not (len(attempts) > 1 and attempts[0]["overflow"] > 0):
            fail(f"capacity factor {factor} did not overflow first: attempts {attempts}")
        launches = [r["seg_scan_launches"] for r in reports]
        if min(launches) < 5:
            fail(f"seg_scan launched {launches} times on the ranks ({name}), expected >= 5 each")
        res[name] = {"reads": b.num_reads, "read_len": int(b.seqs.shape[1]),
                     "capacity_factor": factor, "seconds": seconds, "attempts": attempts,
                     "stages": _rank_stages(reports),
                     "collective_bytes": sum(r["sent_bytes"] for r in reports),
                     "staged_bytes": sum(r["staged_bytes"] for r in reports),
                     "launches_per_rank": launches, "byte_equal_to_smooth_fastq": True}

    # block mode: the ranks against the pipeline's route for this card count
    fq = os.path.join(WORK, "shard_blocks.fastq")
    b = _prefix(batch, SHARD_FLAT_READS)
    with open(fq, "wb") as f:
        f.write(format_fastq(ReadBatch(seqs=b.seqs, quals=b.quals, lengths=b.lengths,
                                       headers=[b"@r%d" % i for i in range(b.num_reads)])))
    seq_base = os.path.join(WORK, "shard_blocks_seq")
    t = time.perf_counter()
    run_pipeline([fq], PipelineConfig(mode=0, rebuild=True), out_base=seq_base,
                 blocks=SHARD_RANKS, device="cuda")
    route_s = time.perf_counter() - t
    log = _read(seq_base + ".log").decode()
    route = "rank-parallel" if "rank-parallel" in log else "sequential"
    t = time.perf_counter()
    got, stats = block_smooth_fastq(read_fastq(fq), cfg, SHARD_RANKS, device="cuda", backend="gloo",
                                    work_dir=WORK)
    seconds = time.perf_counter() - t
    if format_fastq(got, headers=None) != _read(seq_base + ".fq"):
        fail(f"block_smooth_fastq on {SHARD_RANKS} gloo ranks differs from the pipeline's "
             f"{route} block route")
    res["blocks"] = {"reads": b.num_reads, "blocks": SHARD_RANKS, "seconds": seconds,
                     "pipeline_route": route, "pipeline_s": route_s, "stats": stats,
                     "byte_equal_to_pipeline": True}
    res["staged_bytes"] = sum(res[k]["staged_bytes"] for k in cases)
    phase("sharded_ranks", backend="gloo", ranks=SHARD_RANKS, device="cuda:0 (shared)", **res)
    return res


def _cards_rank(comm, seqs, quals, lengths, runs: int):
    """One NCCL rank of phase 9 (c), one card each: smooth_fastq_sharded on
    the group (every rank passes the whole batch), a warm-up and then `runs`
    timed calls; rank 0 also returns the reads."""
    import torch

    from bfqzip_tpu_torch import SmoothConfig
    from bfqzip_tpu_torch.io import ReadBatch
    from bfqzip_tpu_torch.ops import cuda_scan
    from bfqzip_tpu_torch.parallel import smooth_fastq_sharded

    batch = ReadBatch(seqs=seqs.numpy(), quals=quals.numpy(), lengths=lengths.numpy())
    cfg = SmoothConfig()
    smooth_fastq_sharded(batch, cfg, comm=comm)  # warm-up: NCCL sets up its connections
    timed = []
    for _ in range(runs):
        comm.psum(torch.zeros((), device=comm.device))  # the ranks start together
        torch.cuda.synchronize()
        cuda_scan.launches = 0
        reports = []
        t = time.perf_counter()
        out, stats = smooth_fastq_sharded(batch, cfg, comm=comm, reports=reports)
        torch.cuda.synchronize()
        timed.append({"seconds": time.perf_counter() - t, "launches": cuda_scan.launches,
                      "report": reports[0]})
    reads = (out.seqs, out.quals, out.lengths) if comm.rank == 0 else None
    return reads, stats, timed


def sharded_cards(batch, count: int) -> dict:
    """Phase 9 (c): NCCL with one rank per card, d = min(4, cards), at
    `count` reads: the ranks are started once, run a warm-up and 3 timed
    calls, and must match smooth_fastq byte for byte with equal stats.  The
    first call's seconds through the spawning wrapper are kept too.  On a
    one-card machine it does not run, and says why."""
    import numpy as np
    import torch

    from bfqzip_tpu_torch import SmoothConfig
    from bfqzip_tpu_torch.engine import smooth_fastq
    from bfqzip_tpu_torch.io import ReadBatch
    from bfqzip_tpu_torch.parallel import mesh, smooth_fastq_sharded

    cards = torch.cuda.device_count()
    if cards < 2:
        res = {"ran": False, "reason": f"torch.cuda.device_count() is {cards}: NCCL takes one "
                                       "card per rank, and a group of one is phase 9 (a)"}
        phase("sharded_cards", **res)
        return res
    d = min(4, cards)
    cfg = SmoothConfig()
    sub = _prefix(batch, count)
    want, want_stats = smooth_fastq(sub, cfg, device="cuda")
    # through the spawning wrapper: the ranks' start and NCCL's set-up included
    reports = []
    t = time.perf_counter()
    got, stats = smooth_fastq_sharded(sub, cfg, shards=d, device="cuda", work_dir=WORK,
                                      reports=reports)
    cold_s = time.perf_counter() - t
    if not _same_reads(got, want) or stats != want_stats:
        fail(f"sharded over {d} NCCL cards differs from smooth_fastq")
    shared = [torch.from_numpy(np.ascontiguousarray(a)).share_memory_()
              for a in (sub.seqs, sub.quals, sub.lengths)]
    ranks = mesh.spawn(_cards_rank, d, "cuda", WORK, args=(*shared, 3))
    reads, stats, _ = ranks[0]
    got = ReadBatch(seqs=reads[0], quals=reads[1], lengths=reads[2])
    if not _same_reads(got, want) or stats != want_stats:
        fail(f"sharded over {d} NCCL cards (warm group) differs from smooth_fastq")
    run_s = [max(r[2][i]["seconds"] for r in ranks) for i in range(3)]
    last = [r[2][-1]["report"] for r in ranks]
    res = {"ran": True, "backend": "nccl", "ranks": d, "reads": count,
           "cold_call_s": cold_s, "cold_stages": _rank_stages(reports),
           "run_s": run_s, "best_s": min(run_s), "median_s": sorted(run_s)[1],
           "bases_per_s": count * REAL_LEN / min(run_s), "stages": _rank_stages(last),
           "peak_bytes_per_card": max(v for r in last for k, v in r.items()
                                      if k.endswith("_peak_bytes")),
           "collective_bytes": sum(r["sent_bytes"] for r in last),
           "launches_per_rank": [r[2][-1]["launches"] for r in ranks],
           "attempts": last[0]["attempts"], "byte_equal_to_smooth_fastq": True}
    phase("sharded_cards", **res)
    return res


def mesh_refused() -> dict:
    """Phase 9 (d): --mesh with one rank more than the cards exits non-zero
    and names both counts."""
    import contextlib
    import io

    import torch

    from bfqzip_tpu_torch import cli

    cards = torch.cuda.device_count()
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main([os.path.join(WORK, "shard_blocks.fastq"), "-o", os.path.join(WORK, "mesh_refused"),
                       "-0", "--mesh", str(cards + 1)])
    msg = err.getvalue().strip()
    if rc == 0 or f"{cards + 1} CUDA devices" not in msg or f"device_count() is {cards}" not in msg:
        fail(f"--mesh {cards + 1} on {cards} card(s) exited {rc}: {msg!r}")
    res = {"mesh": cards + 1, "cards": cards, "rc": rc, "stderr": msg}
    phase("mesh_refused", **res)
    return res


class _PlainScans:
    """While active, every call of the kernel's wrapper runs the plain
    version on the card instead (and counts no launch)."""

    def __init__(self):
        from bfqzip_tpu_torch.ops import cuda_scan

        self.cuda_scan, self.kernel, self.plain = cuda_scan, cuda_scan.seg_scan, plain_ops()

    def __enter__(self):
        self.cuda_scan.seg_scan = lambda x, f, op, init, reverse=False: self.plain._scan(
            x, f, op, init, reverse)
        return self

    def __exit__(self, *exc):
        self.cuda_scan.seg_scan = self.kernel
        return False


def _pileup_add_at(batch, starts, strands, genome_len: int):
    """The plain pileup on the host: np.add.at over the valid lanes, the
    JAX package's method, independent of the port's device bincount."""
    import numpy as np

    code2base = np.full(6, -1, np.int8)
    code2base[[1, 2, 3, 5]] = [0, 1, 2, 3]  # alphabet codes A C G T
    comp_of = np.array([3, 2, 1, 0], np.int8)
    lens = batch.lengths.astype(np.int64)[:, None]
    offs = np.arange(batch.seqs.shape[1])[None, :]
    gpos = np.where(strands[:, None], starts[:, None] + lens - 1 - offs, starts[:, None] + offs)
    bases = code2base[batch.seqs]
    bases = np.where(strands[:, None], np.where(bases >= 0, comp_of[np.clip(bases, 0, 3)], -1), bases)
    valid = (bases >= 0) & (offs < lens)
    counts = np.zeros((genome_len, 4), np.int64)
    np.add.at(counts, (gpos[valid], bases[valid]), 1)
    return counts


def variant_proxy_phase() -> dict:
    """Phase 10: utils/variant_proxy.run_proxy on the card at phase 5's
    positions (2M x 101 bp over a 6 Mb diploid genome, 2,500 planted SNPs),
    each of its steps timed by a wrapper; the gates, then the preservation
    checks of tests/test_variant_proxy.py, reported and not gated."""
    import numpy as np
    import torch

    from bfqzip_tpu_torch import SmoothConfig
    from bfqzip_tpu_torch.engine import smooth_fastq
    from bfqzip_tpu_torch.ops import cuda_scan
    from bfqzip_tpu_torch.utils import variant_proxy as vp

    steps, outs, originals = {}, {}, {}

    def timed(name):
        fn = originals[name] = getattr(vp, name)

        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            steps.setdefault(name, []).append(time.perf_counter() - t0)
            outs.setdefault(name, []).append(out)
            return out

        setattr(vp, name, run)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for name in ("simulate_diploid", "pileup_counts", "smooth_fastq", "call_snps"):
        timed(name)
    cuda_scan.launches = 0
    t = time.perf_counter()
    try:
        res = vp.run_proxy(PROXY_READS, PROXY_LEN, PROXY_GENOME, PROXY_SNPS, seed=0, device="cuda")
    finally:
        for name, fn in originals.items():
            setattr(vp, name, fn)
    total_s = time.perf_counter() - t
    launches = cuda_scan.launches
    peak = torch.cuda.max_memory_allocated()
    sim = outs["simulate_diploid"][0]
    counts_o, counts_s = outs["pileup_counts"]
    smoothed, stats = outs["smooth_fastq"][0]
    del outs

    if launches != 5:
        fail(f"seg_scan launched {launches} times in run_proxy, expected 5 (one smooth)")
    if res["bases_modified"] <= 0:
        fail("the proxy's smoothing modified no base")
    changed = int((smoothed.seqs != sim.batch.seqs).sum())
    if changed != stats["modified"]:
        fail(f"smoothing changed {changed} bases for modified={stats['modified']}")
    t = time.perf_counter()
    if not np.array_equal(counts_o, _pileup_add_at(sim.batch, sim.starts, sim.strands, PROXY_GENOME)):
        fail("the device pileup differs from np.add.at's on the original reads")
    numpy_pileup_s = time.perf_counter() - t
    t = time.perf_counter()
    with _PlainScans():
        plain, plain_stats = smooth_fastq(sim.batch, SmoothConfig(), device="cuda")
    plain_s = time.perf_counter() - t
    if not (all(np.array_equal(getattr(plain, f), getattr(smoothed, f))
                for f in ("seqs", "quals", "lengths")) and plain_stats == stats):
        fail("run_proxy's smoothed reads differ from a rerun with the plain scans on the card")
    del plain

    o, s = res["original"], res["smoothed"]
    alt_o, alt_s = res["alt_support_orig"], res["alt_support_smooth"]
    drop = alt_o - alt_s
    frac = drop / np.maximum(alt_o, 1)
    ref = sim.genome.astype(np.int64)
    idx = np.arange(PROXY_GENOME)
    non_snp = np.ones(PROXY_GENOME, bool)
    non_snp[sim.snp_pos] = False
    noise = [int((c.sum(1) - c[idx, ref])[non_snp].sum()) for c in (counts_o, counts_s)]
    out = {
        "reads": PROXY_READS, "read_len": PROXY_LEN, "genome_len": PROXY_GENOME,
        "n_snps": PROXY_SNPS, "coverage": PROXY_READS * PROXY_LEN / PROXY_GENOME,
        "original": o, "smoothed": s, "bases_modified": int(res["bases_modified"]),
        "alt_support_drop_max": int(drop.max(initial=0)),
        "alt_support_drop_frac_max": float(frac.max(initial=0.0)),
        "alt_support_mean": [float(alt_o.mean()), float(alt_s.mean())],
        "noise_non_snp": {"original": noise[0], "smoothed": noise[1]},
        "preserved": bool(s["recall"] >= o["recall"] and s["precision"] >= o["precision"]
                          and frac.max(initial=0.0) <= 0.1),
        "launches": launches, "run_proxy_s": total_s,
        "step_s": {"simulate": steps["simulate_diploid"][0], "pileup": steps["pileup_counts"],
                   "smooth_fastq": steps["smooth_fastq"][0], "call_snps": steps["call_snps"]},
        "numpy_pileup_s": numpy_pileup_s, "plain_rerun_s": plain_s, "peak_bytes": peak,
        "pileup_equal_to_numpy": True, "kernel_vs_plain_reads": True, "stats": stats,
    }
    phase("variant_proxy", **out)
    return out


def profile_phase(batch) -> dict:
    """Phase 11: tools/profile_stages_torch.py's profile of phase 5's reads:
    stage times, then one traced smooth_step with its device timeline."""
    from bfqzip_tpu_torch.ops import cuda_scan

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from profile_stages_torch import profile_batch

    cuda_scan.launches = 0
    res = profile_batch(batch, "cuda", os.path.join(WORK, "profile"))
    launches = cuda_scan.launches
    if res["seg_scan_launches"] != 5 or res["seg_scan_kernels"] != 5:
        fail(f"the traced smooth_step launched seg_scan {res['seg_scan_launches']} times and the "
             f"trace holds {res['seg_scan_kernels']} of its kernels, expected 5 and 5")
    if res["idle_share"] is None:
        fail("the trace holds no device events: no idle share")
    out = {"launches": launches, **res}
    phase("profile", **out)
    return out


def _tool_json(argv, env=None) -> dict:
    """Run a script in a subprocess from the repository root; the JSON of
    the last line it printed."""
    proc = subprocess.run([sys.executable, *argv], cwd=ROOT, capture_output=True, text=True,
                          timeout=600, env={**os.environ, **(env or {})})
    if proc.returncode != 0:
        fail(f"{' '.join(argv)} exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _names_card(res, what: str) -> None:
    import torch

    dev = res["device"]
    if dev["type"] != "cuda" or dev["name"] != torch.cuda.get_device_name(0) or not dev["power_limit"]:
        fail(f"{what} ran on {dev}, not on the card")


def entry_points(batch) -> dict:
    """Phase 12: the port's measurement entry points and the BQZE codec on
    the card: (a) bfqzip_tpu_torch.bench in this process on phase 5's
    reads and as `python -m` at its default size, (b)
    tools/profile_build_torch.py and (c) tools/profile_smooth_torch.py on
    phase 5's reads, (d) tools/run_ext10m_torch.py on phase 5's first
    EXT_TOOL_READS reads under a 1 GiB budget, (e) a BQZE container of
    phase 6's smoothed DNA stream encoded and decoded on the card."""
    import torch

    from bfqzip_tpu_torch import SmoothConfig, bench
    from bfqzip_tpu_torch.engine import smooth_fastq
    from bfqzip_tpu_torch.io import ReadBatch, format_fastq
    from bfqzip_tpu_torch.models.dna_ebwt import decode_dna_stream, encode_dna_stream
    from bfqzip_tpu_torch.ops import cuda_scan

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import profile_build_torch
    import profile_smooth_torch

    t_phase = time.perf_counter()
    res = {}
    launches = 0

    # (a) bench: in this process at 2M reads, then the module at its default size
    cuda_scan.launches = 0
    res["bench"] = bench.run(batch, "cuda", reps=3)
    launches += cuda_scan.launches
    torch.cuda.empty_cache()  # the subprocesses below need the card's memory
    res["bench_default"] = _tool_json(["-m", "bfqzip_tpu_torch.bench"])
    launches += sum(res["bench_default"]["seg_scan_launches"])
    for key in ("bench", "bench_default"):
        _names_card(res[key], key)
        if res[key]["seg_scan_launches"] != [5, 5, 5]:
            fail(f"{key}: seg_scan launched {res[key]['seg_scan_launches']} times per smooth_step, "
                 "expected 5 each")
    phase("entry_points_bench", bench_2m=res["bench"], bench_default=res["bench_default"])

    # (b) the build, piece by piece, with a trace of one whole build
    res["build"] = profile_build_torch.profile(batch, "cuda", os.path.join(WORK, "profile_build"))
    _names_card(res["build"], "profile_build_torch")
    pieces = res["build"]["pieces"]
    if not all(p["ms"] > 0 and p["bound_ms"] for p in pieces.values()) or not res["build"]["trace"]:
        fail(f"profile_build_torch: a piece was not timed on the card: {pieces}")
    phase("entry_points_build", **res["build"])

    # (c) smooth, step by step
    cuda_scan.launches = 0
    res["smooth"] = profile_smooth_torch.profile(batch, "cuda", os.path.join(WORK, "profile_smooth"))
    launches += cuda_scan.launches
    _names_card(res["smooth"], "profile_smooth_torch")
    if res["smooth"]["smooth"]["seg_scan_launches"] != 5:
        fail(f"profile_smooth_torch: {res['smooth']['smooth']['seg_scan_launches']} seg_scan "
             "launches in one smooth, expected 5")
    if any(s["kernel_launches"] is None for s in res["smooth"]["steps"].values()):
        fail("profile_smooth_torch: a step's trace holds no device kernels")
    phase("entry_points_smooth", **res["smooth"])

    # (d) the out-of-core tool on a FASTQ, against smooth_fastq on the same reads
    k = EXT_TOOL_READS
    small = ReadBatch(seqs=batch.seqs[:k], quals=batch.quals[:k], lengths=batch.lengths[:k],
                      headers=[b"@r%d" % i for i in range(k)])
    fq, out = os.path.join(WORK, "ext_tool.fastq"), os.path.join(WORK, "ext_tool.fq")
    with open(fq, "wb") as f:
        f.write(format_fastq(small))
    torch.cuda.empty_cache()
    ext = _tool_json(["tools/run_ext10m_torch.py", fq, "--mem-gb", "1", "--out", out],
                     env={"BFQ_SPILL_DIR": WORK})
    launches += ext["seg_scan_launches"]
    _names_card(ext, "run_ext10m_torch")
    ref, ref_stats = smooth_fastq(small, SmoothConfig(), device="cuda")
    if _read(out) != format_fastq(ref, headers=None) or ext["stats"] != ref_stats:
        fail(f"run_ext10m_torch at {k} reads differs from smooth_fastq")
    if ext["peak_device_bytes"] > ext["budget_bytes"]:
        fail(f"run_ext10m_torch: peak device bytes {ext['peak_device_bytes']} exceed the "
             f"{ext['budget_bytes']}-byte budget")
    res["ext"] = {**ext, "byte_equal_to_smooth_fastq": True}
    phase("entry_points_ext", **res["ext"])
    del small, ref

    # (e) BQZE: phase 6's smoothed DNA stream of CODEC_READS reads through
    # the card, and the CPU's container of the same bytes
    data = _read(os.path.join(WORK, "small.fq.dna"))
    cuda_scan.launches = 0
    torch.cuda.synchronize()
    t = time.perf_counter()
    blob = encode_dna_stream(data, device="cuda")
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t
    t = time.perf_counter()
    back = decode_dna_stream(blob, device="cuda")
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t
    launches += cuda_scan.launches
    if back != data:
        fail("BQZE on the card: the decoded stream differs from the input")
    t = time.perf_counter()
    cpu_blob = encode_dna_stream(data, device="cpu")
    cpu_encode_s = time.perf_counter() - t
    if cpu_blob != blob:
        fail("BQZE: the card's container differs from the CPU's")
    res["bqze"] = {"reads": CODEC_READS, "stream_bytes": len(data), "container_bytes": len(blob),
                   "ratio": len(data) / len(blob), "entropy_coder": blob[32:36].decode(),
                   "encode_s": encode_s, "decode_s": decode_s, "cpu_encode_s": cpu_encode_s,
                   "encode_mb_s": len(data) / 1e6 / encode_s, "decode_mb_s": len(data) / 1e6 / decode_s,
                   "decode_launches": cuda_scan.launches, "round_trip": True, "equal_to_cpu": True}
    phase("entry_points_bqze", **res["bqze"])
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    phase("entry_points", seconds=res["seconds"], launches=launches)
    return res


def tools_phase() -> dict:
    """Phase 13: the seven microbenchmark and codec tools on the card, each
    through _tool_json at its default size, with their gates; the seg_scan
    launches of the two tools that run the kernel."""
    import torch

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()  # the tools run in subprocesses and need the card's memory
    res = {}
    for name in ("bench_prims", "bench_prims2", "microbench_sort", "exp_unstable_sort", "exp_overlap",
                 "bench_cm", "bench_decode_scaling"):
        t = time.perf_counter()
        args, env = TOOL_RUN.get(name, ([], None))
        out = _tool_json([f"tools/{name}_torch.py", *args], env=env)
        _names_card(out, f"{name}_torch")
        out["tool_seconds"] = time.perf_counter() - t
        phase(f"tools_{name}", **out)
        res[name] = out

    prims, prims2 = res["bench_prims"], res["bench_prims2"]
    if not all(prims["checks"].values()):
        fail(f"bench_prims_torch: a check failed: {prims['checks']}")
    for label, row in prims2["candidates"].items():
        if row["equal"] is not True:
            fail(f"bench_prims2_torch: {label} through the kernel differs from the plain version")
    if prims2["candidates"]["two-level(B=8) seg-sum [n] i32"]["plain_equal"] is not True:
        fail("bench_prims2_torch: the two-level sum differs from the one-level one")
    unstable, overlap = res["exp_unstable_sort"], res["exp_overlap"]
    if not (unstable["invert_identical"] and unstable["scatter_identical"]):
        fail("exp_unstable_sort_torch: the invert's sorts or its scatter disagree")
    if not overlap["chunks_equal"]:
        fail("exp_overlap_torch: a chunk's reads differ from smooth_fastq's")
    if overlap["launches_per_stage_triple"] != [5]:
        fail(f"exp_overlap_torch: {overlap['launches_per_stage_triple']} seg_scan launches per "
             "stage triple, expected 5")
    launches = {"bench_prims2_torch": prims2["seg_scan_launches"],
                "exp_overlap_torch": overlap["seg_scan_launches"]}
    if not all(n > 0 for n in launches.values()):
        fail(f"a scan tool launched no seg_scan: {launches}")
    if not (res["bench_cm"]["dna"]["byte_equal"] and res["bench_cm"]["qs"]["byte_equal"]):
        fail("bench_cm_torch: a decode differs")
    cores = res["bench_decode_scaling"]["host"]["affinity"]
    want = {str(k) for k in (1, 2, 4, 8) if k <= max(cores, 2)}
    for s in res["bench_decode_scaling"]["streams"]:
        if not s["byte_equal"]:
            fail(f"bench_decode_scaling_torch: a {s['stream']} decode differs")
        if set(s["measured_s"]) != want:
            fail(f"bench_decode_scaling_torch: measured {sorted(s['measured_s'])} threads on "
                 f"{cores} cores, expected {sorted(want)}")
    res["launches"] = launches
    res["seconds"] = time.perf_counter() - t_phase
    phase("tools", seconds=res["seconds"], launches=launches)
    return res


def native_make():
    """Start `make -B -C native` (the host codec library) in the background.
    -B rebuilds a copy left in the tree: it is built with -march=native and
    may come from another host's CPU."""
    return subprocess.Popen(["make", "-B", "-C", os.path.join(ROOT, "native")],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def main(argv) -> int:
    import torch

    if argv not in ([], ["sharded"], ["cards"]):
        fail(f"unknown arguments {argv}: none runs every phase, 'sharded' phases 1, 2 and 9, "
             "'cards' phases 1, 2 and 9 (c)")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an NVIDIA GPU")
    if argv:
        environment()
        build()
        batch, _ = real_batch()
        if argv == ["cards"]:
            if torch.cuda.device_count() < 2:
                fail("'cards' needs two or more cards")
            sharded_cards(batch, REAL_READS)
        else:
            world1 = sharded_world1(batch)
            sharded_ranks(batch)
            sharded_cards(batch, world1["reads"])
            mesh_refused()
        print(f"phases 1, 2 and 9{' (c)' if argv == ['cards'] else ''} only: no result line")
        return 0
    t_make = time.time()
    make = native_make()
    try:
        smi = environment()
        build()
        max_abs = kernel_vs_plain()
        make_log = make.communicate()[0]
        made = (make.returncode, make_log, time.time() - t_make)
    finally:
        if make.poll() is None:
            make.kill()
            make.wait()
    goldens()
    batch, t_data = real_batch()
    real = real_size(batch, t_data)
    cli = cli_path(batch, made)
    long = long_reads()
    ext = external_path(cli)
    world1 = sharded_world1(batch)
    ranks = sharded_ranks(batch)
    sharded_cards(batch, world1["reads"])
    mesh_refused()
    proxy = variant_proxy_phase()
    prof = profile_phase(batch)
    entry = entry_points(batch)
    del batch
    tools = tools_phase()
    for package in ("jax", "bfqzip_tpu"):
        if package in sys.modules:
            fail(f"{package} was imported")
    scans = real["scan_launches"]
    ms = sum(r["ms"] for r in scans)
    print(json.dumps({"kernels": [{
        "name": "seg_scan", "route": "cuda", "source": "bfqzip_tpu_torch/csrc/seg_scan.cu",
        "replaces": "bfqzip_tpu/ops/pallas_scan.py:89",
        "launches": (real["launches"] + cli["launches"] + long["launches"] + ext["launches"]
                     + sum(world1["launches_per_call"]) + proxy["launches"] + prof["launches"]
                     + entry["launches"] + sum(tools["launches"].values())),
        # phase 13's launches, from the two scan tools' own lines
        "tool_launches": tools["launches"],
        # seg_scan launches of one sharded call: world 1 in this process, and
        # each of the gloo ranks sharing the card (flat body)
        "sharded_launches_per_call": {"world1": world1["launches_per_call"],
                                      f"gloo{SHARD_RANKS}_per_rank": ranks["flat"]["launches_per_rank"]},
        "max_abs_err": max_abs,
        # the five launches of one phase-5 smooth at the main path's shapes
        "ms": ms, "plain_ms": sum(r["plain_ms"] for r in scans),
        "bound_ms": sum(r["bound_ms"] for r in scans), "bound_by": "bytes",
        "bound_share": sum(r["bound_ms"] for r in scans) / ms,
        "library_ms": sum(r["library_ms"] for r in scans),
        "library_call": "torch.cumsum / torch.cummax along the last axis (unsegmented)",
        "per_launch": scans,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

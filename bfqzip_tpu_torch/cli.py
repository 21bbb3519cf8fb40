"""Command-line entry point of the port, with the JAX package's flags and exit codes.

    python -m bfqzip_tpu_torch INPUT.fastq -o OUT --m3          # on the GPU
    python -m bfqzip_tpu_torch INPUT.fastq -o OUT --m3 --cpu    # on the CPU

Without --cpu the device is `cuda`, and a run without a card exits non-zero
with the reason on stderr.  --ext-mem [--mem MB] runs the out-of-core path
under a device-memory budget.  --mesh D builds ONE global EBWT over D ranks:
D cards on CUDA (fewer cards exit non-zero, naming both counts), D gloo
ranks with --cpu.  --restore and --decompress run the host codecs; an old
BQZE stream inverts its EBWT on the card, or on the CPU under --cpu.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser():
    p = argparse.ArgumentParser(
        prog="bfqzip_tpu_torch",
        description="lossy FASTQ compression via the EBWT, on PyTorch (CUDA or CPU)",
    )
    p.add_argument("input", nargs="+", help="input FASTQ file(s); two files with --paired")
    p.add_argument("-o", "--out", default="", help="output base name (default: input name)")
    p.add_argument("-T", "--mcl", type=int, default=None, help="minimum context length K (default 16)")
    p.add_argument("-Q", "--rv", default="", help="constant replacement quality character (default '>')")
    p.add_argument("-M", "--smooth-mode", type=int, default=2, choices=(0, 1, 2, 3),
                   help="smoothing strategy: 0=max 1=mean-error 2=constant 3=avg (default 2)")
    p.add_argument("-B", "--binning", action="store_true", help="Illumina 8-level binning")
    p.add_argument("-m", "--min-cluster", type=int, default=5, help="minimum cluster size (default 5)")
    p.add_argument("--qs-threshold", type=int, default=20, metavar="Q",
                   help="quality threshold for trusted bases (reference bfq_int -t, default 20)")
    p.add_argument("--freq-threshold", type=float, default=40.0, metavar="PCT",
                   help="frequent-base percentage threshold (reference bfq_int -f, default 40)")
    p.add_argument("--rebuild", action="store_true", help="force step 1 (ignore cached artifacts)")
    p.add_argument("--original", action="store_true", help="skip smoothing (compress input as-is)")
    p.add_argument("-1", "--m1", action="store_true", help="mode 1: whole FASTQ stream")
    p.add_argument("-2", "--m2", action="store_true", help="mode 2: DNA+QS streams")
    p.add_argument("-3", "--m3", action="store_true", help="mode 3: DNA+QS+headers streams")
    p.add_argument("-0", "--m0", action="store_true", help="mode 0: no compression")
    p.add_argument("--headers", action="store_true", help="keep original headers")
    p.add_argument("--reorder", type=int, default=0, choices=(0, 1, 2),
                   help="reorder reads first: 1=random 2=similarity (default 0)")
    p.add_argument("-p", "--paired", action="store_true", help="paired-end mode (two inputs)")
    p.add_argument("-t", "--threads", type=int, default=0,
                   help="split into this many independent blocks (reference parallel mode)")
    p.add_argument("--mesh", type=int, default=0, metavar="D",
                   help="sequence-shard ONE global EBWT over D devices "
                        "(no per-block ratio cost; needs D devices visible)")
    p.add_argument("--ext-mem", action="store_true",
                   help="out-of-core mode: chunked device sorts + host merge "
                        "(the BFQzip_ext.py engine; 1-byte LCP)")
    p.add_argument("--mem", type=int, default=4096, metavar="MB",
                   help="device memory budget for --ext-mem (default 4096, "
                        "reference BFQzip_ext.py --mem)")
    p.add_argument("-c", "--check", action="store_true", help="validate the input FASTQ")
    p.add_argument("-v", type=int, default=0, dest="verbose", help="verbosity")
    p.add_argument("--codecs", default="rans",
                   help="comma-separated step-5 backends: rans,ppmd,bsc (default rans; "
                        "ppmd/bsc shell out to 7z/bsc when installed)")
    p.add_argument("-D", "--debug-dump", action="store_true",
                   help="write a per-position TSV of BWT/QS/LCP flags and print cluster/QS histograms (reference -D/-V modes)")
    p.add_argument("--decompress", action="store_true", help="decode .rans containers given as inputs")
    p.add_argument("--restore", action="store_true",
                   help="reassemble a FASTQ from a compressed output base name")
    p.add_argument("--cpu", action="store_true", help="force the CPU backend")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    if args.decompress:
        from bfqzip_tpu_torch.pipeline import decompress_stream

        if args.out and len(args.input) != 1:
            print("error: --decompress -o takes exactly one input", file=sys.stderr)
            return 2
        for path in args.input:
            out = decompress_stream(path, args.out or None, device)
            print(f"{path} -> {out}")
        return 0

    if args.restore:
        from bfqzip_tpu_torch.pipeline import restore_fastq

        if len(args.input) != 1:
            print("error: --restore takes the output base name", file=sys.stderr)
            return 2
        t0 = time.time()
        out = restore_fastq(args.input[0], args.out or None, device)
        dt = max(time.time() - t0, 1e-9)
        outs = out if isinstance(out, tuple) else (out,)
        mb = sum(os.path.getsize(p) for p in outs) / 1e6
        print(f"{args.input[0]} -> {' + '.join(outs)}")
        print(f"restored {mb:.1f} MB in {dt:.2f} s ({mb / dt:.1f} MB/s)")
        return 0

    from bfqzip_tpu_torch.config import PipelineConfig, SmoothConfig
    from bfqzip_tpu_torch.engine import resolve_device
    from bfqzip_tpu_torch.pipeline import run_pipeline

    mode = 1
    if args.m0:
        mode = 0
    if args.m2:
        mode = 2
    if args.m3:
        mode = 3

    if args.paired and len(args.input) != 2:
        print("error: --paired needs exactly two input files", file=sys.stderr)
        return 2
    if not args.paired and len(args.input) != 1:
        print("error: exactly one input file expected (use --paired for two)", file=sys.stderr)
        return 2

    smooth = SmoothConfig(
        k=args.mcl if args.mcl is not None else 16,
        min_cluster=args.min_cluster,
        mode=args.smooth_mode,
        default_qs=ord(args.rv) if args.rv else ord(">"),
        quality_threshold=args.qs_threshold,
        freq_threshold=args.freq_threshold,
        binning=args.binning,
    )
    cfg = PipelineConfig(
        smooth=smooth,
        mode=mode,
        headers=args.headers or mode == 3,
        rebuild=args.rebuild,
        original=args.original,
        codecs=tuple(c.strip() for c in args.codecs.split(",") if c.strip()),
    )

    for path in args.input:
        if not os.path.exists(path):
            print(f"error: input file not found: {path}", file=sys.stderr)
            return 2

    try:
        resolve_device(device)
    except RuntimeError as e:
        print(f"error: {e} (pass --cpu to run on the CPU)", file=sys.stderr)
        return 1
    if args.mesh > 1:
        from bfqzip_tpu_torch.parallel.mesh import check_world

        try:
            check_world(args.mesh, device)
        except ValueError as e:
            print(f"error: --mesh {args.mesh}: {e}", file=sys.stderr)
            return 1

    result = run_pipeline(
        args.input,
        cfg,
        out_base=args.out or None,
        check=args.check,
        reorder=args.reorder,
        blocks=args.threads,
        mesh_shards=args.mesh,
        ext_mem_mb=args.mem if args.ext_mem else 0,
        debug_dump=args.debug_dump,
        device=device,
    )
    if args.verbose:
        print("=== results ===")
        for k, v in result.report.items():
            print(f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

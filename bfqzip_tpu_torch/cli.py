"""Command-line entry point of the port, with the JAX package's parser and exit codes.

    python -m bfqzip_tpu_torch INPUT.fastq -o OUT --m3          # on the GPU
    python -m bfqzip_tpu_torch INPUT.fastq -o OUT --m3 --cpu    # on the CPU

Without --cpu the device is `cuda`, and a run without a card exits non-zero
with the reason on stderr.  --ext-mem [--mem MB] runs the out-of-core path
under a device-memory budget.  --mesh is not ported yet: it exits 2.
--restore and --decompress run the host codecs and need no card.
"""

from __future__ import annotations

import os
import sys
import time

from bfqzip_tpu.cli import build_parser as _jax_parser


def build_parser():
    p = _jax_parser()
    p.prog = "bfqzip_tpu_torch"
    p.description = "lossy FASTQ compression via the EBWT, on PyTorch (CUDA or CPU)"
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = "cpu" if args.cpu else "cuda"

    if args.mesh:
        print("error: --mesh is not ported yet to bfqzip_tpu_torch "
              "(ROADMAP.md Queue 1 item 12); use python -m bfqzip_tpu", file=sys.stderr)
        return 2

    if args.decompress:
        from bfqzip_tpu_torch.pipeline import decompress_stream

        if args.out and len(args.input) != 1:
            print("error: --decompress -o takes exactly one input", file=sys.stderr)
            return 2
        for path in args.input:
            out = decompress_stream(path, args.out or None)
            print(f"{path} -> {out}")
        return 0

    if args.restore:
        from bfqzip_tpu_torch.pipeline import restore_fastq

        if len(args.input) != 1:
            print("error: --restore takes the output base name", file=sys.stderr)
            return 2
        t0 = time.time()
        out = restore_fastq(args.input[0], args.out or None)
        dt = max(time.time() - t0, 1e-9)
        outs = out if isinstance(out, tuple) else (out,)
        mb = sum(os.path.getsize(p) for p in outs) / 1e6
        print(f"{args.input[0]} -> {' + '.join(outs)}")
        print(f"restored {mb:.1f} MB in {dt:.2f} s ({mb / dt:.1f} MB/s)")
        return 0

    from bfqzip_tpu.config import PipelineConfig, SmoothConfig
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

    result = run_pipeline(
        args.input,
        cfg,
        out_base=args.out or None,
        check=args.check,
        reorder=args.reorder,
        blocks=args.threads,
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

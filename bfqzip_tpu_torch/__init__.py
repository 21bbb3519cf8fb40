"""bfqzip_tpu_torch — the PyTorch + CUDA port of bfqzip_tpu for NVIDIA Hopper.

The compression pipeline and its CLI on PyTorch tensors: EBWT + QS + LCP
build, positional cluster smoothing, inversion (SA scatter in memory, LF walk
from the cached artifacts), stream split and host entropy coding, with the
segmented scan as a hand-written CUDA kernel (csrc/seg_scan.cu).  The JAX
package bfqzip_tpu stays the reference; this package imports torch and never
jax, and nothing of bfqzip_tpu: it carries its own copies of the host
modules it needs (alphabet, config, io.fastq / io.spill, models.context,
utils.native / reorder / debug / logging / checkfastq, and the CLI parser).

  bfqzip_tpu_torch.cli       python -m bfqzip_tpu_torch (same flags as bfqzip_tpu)
  bfqzip_tpu_torch.pipeline  steps 1-5 with the artifact cache, restore, decompress
  bfqzip_tpu_torch.engine    smooth_fastq / smooth_arrays_step
  bfqzip_tpu_torch.parallel  torch.distributed ranks: the sequence-sharded global
                             EBWT pipeline, block parallelism, sample sort
  bfqzip_tpu_torch.ops       suffix build, scans, rank/LF, smoothing, inversion, rANS
  bfqzip_tpu_torch.models    BQZH header codec, BQZE decoder
  bfqzip_tpu_torch.convert   numpy <-> tensor state (EBWT, read batches)
  bfqzip_tpu_torch.io        FASTQ parse / format, spill-backed arrays
  bfqzip_tpu_torch.utils     nvcc build of csrc/*.cu (ctypes), native host codecs,
                             StepLogger, profiling (phase timers, torch.profiler
                             timelines), the variant-preservation proxy,
                             checkfastq, reorder, debug dumps

No device is chosen at import: callers pass one.
"""

from bfqzip_tpu_torch.config import SmoothConfig  # noqa: F401

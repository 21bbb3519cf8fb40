"""bfqzip_tpu_torch — the PyTorch + CUDA port of bfqzip_tpu for NVIDIA Hopper.

The in-memory one-batch smoothing path (EBWT + QS + LCP build, positional
cluster smoothing, inversion) on PyTorch tensors, with the segmented scan as
a hand-written CUDA kernel (csrc/seg_scan.cu).  The JAX package bfqzip_tpu
stays the reference; this package imports torch and never jax, and reuses
only bfqzip_tpu's host-only modules (alphabet, config, io.fastq).

  bfqzip_tpu_torch.engine   smooth_step / smooth_fastq
  bfqzip_tpu_torch.ops      suffix build, scans, smoothing, inversion
  bfqzip_tpu_torch.convert  numpy <-> tensor state (EBWT, read batches)
  bfqzip_tpu_torch.utils    nvcc build of csrc/*.cu, loaded with ctypes

No device is chosen at import: callers pass one.
"""

from bfqzip_tpu.config import SmoothConfig  # noqa: F401

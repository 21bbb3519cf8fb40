"""FASTQ I/O of the port (host-only numpy code, the JAX package's own copied).

  io.fastq  ReadBatch, read_fastq / format_fastq / fastq_array / write_fastq
  io.spill  file-backed scratch arrays of the out-of-core path
"""

from bfqzip_tpu_torch.alphabet import decode, encode  # noqa: F401
from bfqzip_tpu_torch.io.fastq import ReadBatch, fastq_array, format_fastq, read_fastq, write_fastq  # noqa: F401

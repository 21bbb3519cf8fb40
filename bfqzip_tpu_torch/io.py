"""FASTQ I/O of the port: the host-only numpy code shared with bfqzip_tpu.

bfqzip_tpu.io.fastq and bfqzip_tpu.alphabet import no jax, so the port
reuses them instead of carrying a copy.
"""

from bfqzip_tpu.alphabet import decode, encode  # noqa: F401
from bfqzip_tpu.io.fastq import ReadBatch, format_fastq, read_fastq, write_fastq  # noqa: F401

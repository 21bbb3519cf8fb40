"""Host helpers of the port: FASTQ checking, logging, profiling, the
variant-preservation proxy, the native-library loader and the nvcc build."""

from bfqzip_tpu_torch.utils.checkfastq import check_fastq  # noqa: F401

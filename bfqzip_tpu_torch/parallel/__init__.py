from bfqzip_tpu_torch.parallel.mesh import init_group, spawn  # noqa: F401
from bfqzip_tpu_torch.parallel.block import block_smooth_rank, block_smooth_fastq  # noqa: F401
from bfqzip_tpu_torch.parallel.sharded_sort import sharded_sort  # noqa: F401
from bfqzip_tpu_torch.parallel.global_pipeline import smooth_fastq_sharded  # noqa: F401

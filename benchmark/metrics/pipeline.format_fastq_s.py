"""pipeline.format_fastq_s: host seconds of io/fastq.format_fastq on the
smoothed reads, the .fq's bytes, per CLI file.

Source: the program's span `pipeline.format_fastq`
(bfqzip_tpu_torch.utils.profiling), recorded in the traced window: its host
seconds, summed over the window, over the `cli.main` spans, one a file."""

from span_reads import per_call


def read(rec):
    value = per_call(("pipeline.format_fastq",), "host_ms", "cli.main")
    return None if value is None else value / 1e3

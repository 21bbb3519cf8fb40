"""pipeline.stream_split_s: host seconds of step 4, the cut of the .fq into
the DNA and quality streams and their writes, per CLI file.

Source: the program's span `pipeline.stream_split`
(bfqzip_tpu_torch.utils.profiling), recorded in the traced window: its host
seconds, summed over the window, over the `cli.main` spans, one a file."""

from span_reads import per_call


def read(rec):
    value = per_call(("pipeline.stream_split",), "host_ms", "cli.main")
    return None if value is None else value / 1e3

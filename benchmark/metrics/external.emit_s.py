"""external.emit_s: host seconds of the out-of-core route's emission, which
unpacks the inverted text into the smoothed reads (spill-backed arrays),
per file.

Source: the program's span `external.emit`
(bfqzip_tpu_torch.utils.profiling), recorded in the traced window: its host
seconds, summed over the window, over the `external.smooth_fastq` spans,
one a file."""

from span_reads import per_call


def read(rec):
    value = per_call(("external.emit",), "host_ms", "external.smooth_fastq")
    return None if value is None else value / 1e3

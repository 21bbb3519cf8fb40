"""external.segment_span_ms: milliseconds on the card of the out-of-core
route's smoothing segments (the uploads of a segment's window, the forward
pass with its carried scans and the copy of its packed output to the host),
per file.

Source: the program's span `external.segment`
(bfqzip_tpu_torch.utils.profiling), one a segment, recorded in the traced
window: the time between its two CUDA events on the card, summed over the
window and divided by the `external.smooth_fastq` spans, one a file."""

from span_reads import per_call


def read(rec):
    return per_call(("external.segment",), "device_ms", "external.smooth_fastq")

"""external.scatter_s: host seconds of the out-of-core route's inversion,
the scatter of each smoothed segment to its text positions in the host
array (packed[(SA - 1) mod n_pad] = ...), per file.

Source: the program's span `external.scatter`
(bfqzip_tpu_torch.utils.profiling), one a segment, recorded in the traced
window: its host seconds, summed over the window, over the
`external.smooth_fastq` spans, one a file."""

from span_reads import per_call


def read(rec):
    value = per_call(("external.scatter",), "host_ms", "external.smooth_fastq")
    return None if value is None else value / 1e3

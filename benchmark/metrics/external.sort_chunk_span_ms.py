"""external.sort_chunk_span_ms: milliseconds on the card's timeline of the
out-of-core route's chunk sorts, from a chunk's uploads to its suffix
positions and LCPs stored in the host arrays, per file.

Source: the program's span `external.sort_chunk`
(bfqzip_tpu_torch.utils.profiling), one a chunk, recorded in the traced
window: the time between its two CUDA events on the card (the copies back
are synchronous, so the closing event also waits for the host's store),
summed over the window and divided by the `external.smooth_fastq` spans,
one a file."""

from span_reads import per_call


def read(rec):
    return per_call(("external.sort_chunk",), "device_ms", "external.smooth_fastq")

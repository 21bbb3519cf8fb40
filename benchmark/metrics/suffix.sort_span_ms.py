"""suffix.sort_span_ms: milliseconds on the card of the flat build's LSD sort
of the key words (ops/suffix._sort_lsd), per smooth_fastq call.

Source: the program's span `suffix.sort_lsd`
(bfqzip_tpu_torch.utils.profiling), recorded in the traced window: the time
between its two CUDA events on the card, summed over the window and divided
by the `engine.smooth_fastq` spans, one a call. These are the window's own
calls, whose rate is `bases_per_s`, with no synchronise between the stages."""

from span_reads import per_call


def read(rec):
    return per_call(("suffix.sort_lsd",), "device_ms", "engine.smooth_fastq")

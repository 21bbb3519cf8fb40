"""smooth.cluster_words_span_ms: milliseconds on the card of the smoother's
cluster_words (predicates, segmented scans, decision words), per
smooth_fastq call.

Source: the program's span `smooth.cluster_words`
(bfqzip_tpu_torch.utils.profiling), recorded in the traced window: the time
between its two CUDA events on the card, summed over the window and divided
by the `engine.smooth_fastq` spans, one a call. These are the window's own
calls, whose rate is `bases_per_s`, with no synchronise between the stages."""

from span_reads import per_call


def read(rec):
    return per_call(("smooth.cluster_words",), "device_ms", "engine.smooth_fastq")

"""suffix.build_span_ms: milliseconds on the card of ops/suffix.build_ebwt, the
whole build (flat: pack, sort, post, lcp), per smooth_fastq call.

Source: the program's span `suffix.build_ebwt`
(bfqzip_tpu_torch.utils.profiling), recorded in the traced window: the time
between its two CUDA events on the card, summed over the window and divided
by the `engine.smooth_fastq` spans, one a call. These are the window's own
calls, whose rate is `bases_per_s`, with no synchronise between the stages."""

from span_reads import per_call


def read(rec):
    return per_call(("suffix.build_ebwt",), "device_ms", "engine.smooth_fastq")

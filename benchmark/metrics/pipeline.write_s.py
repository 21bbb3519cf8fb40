"""pipeline.write_s: host seconds of every write of an output file: the .bwt,
.bwt.qs, .lcp, .meta.json, .h and .fq, per CLI file.

Source: the program's span `pipeline.write`
(bfqzip_tpu_torch.utils.profiling), recorded in the traced window: its host
seconds, summed over the window, over the `cli.main` spans, one a file."""

from span_reads import per_call


def read(rec):
    value = per_call(("pipeline.write",), "host_ms", "cli.main")
    return None if value is None else value / 1e3

"""codec.headers_s: host seconds of the header codec (BQZH) a file: the .h
stream's tokenising, delta coding and per-field entropy coding.

Source: the program's span `headers.encode`
(bfqzip_tpu_torch.models.headers), recorded in the traced window on one of
step 5's threads: host seconds, summed over the window, over the
`cli.main` spans, one a file."""

from span_reads import per_call


def read(rec):
    value = per_call(("headers.encode",), "host_ms", "cli.main")
    return None if value is None else value / 1e3

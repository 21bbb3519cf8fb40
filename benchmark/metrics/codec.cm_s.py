"""codec.cm_s: host seconds of the context-model coder (BQZC) a file,
summed over the streams (thread time: the streams are encoded at once),
the .h stream's field codings included.

Source: the program's span `codec.cm` (bfqzip_tpu_torch.ops.rans), one a
BQZC encode, recorded in the traced window on step 5's threads: host
seconds, summed over the window, over the `cli.main` spans, one a file."""

from span_reads import per_call


def read(rec):
    value = per_call(("codec.cm",), "host_ms", "cli.main")
    return None if value is None else value / 1e3

"""codec.rans_s: host seconds of the static rANS coder (BQZR, orders 0-2,
native or NumPy) a file, summed over the streams (thread time), the .h
stream's field codings included.

Source: the program's span `codec.rans` (bfqzip_tpu_torch.ops.rans), one
an `encode_best`, recorded in the traced window on step 5's threads: host
seconds, summed over the window, over the `cli.main` spans, one a file."""

from span_reads import per_call


def read(rec):
    value = per_call(("codec.rans",), "host_ms", "cli.main")
    return None if value is None else value / 1e3

"""codec.compress_s: host seconds of step 5's in-tree coder a file: the
wall time in which the streams are encoded at once on its threads and
their archives written.

Source: the program's span `codec.compress`
(bfqzip_tpu_torch.utils.profiling), recorded in the traced window: its host
seconds, summed over the window, over the `cli.main` spans, one a file."""

from span_reads import per_call


def read(rec):
    value = per_call(("codec.compress",), "host_ms", "cli.main")
    return None if value is None else value / 1e3

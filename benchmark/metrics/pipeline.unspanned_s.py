"""pipeline.unspanned_s: host seconds of cli.main that no span inside it
covers: argument parsing, the log, the cache check and the rest of the CLI's
own work, per CLI file.

Source: the program's root span `cli.main`
(bfqzip_tpu_torch.utils.profiling), recorded in the traced window: its self
time (its host time less what its child spans cover), summed over the
window, over the `cli.main` spans, one a file."""

from span_reads import per_call


def read(rec):
    value = per_call(("cli.main",), "self_ms", "cli.main")
    return None if value is None else value / 1e3

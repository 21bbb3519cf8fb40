"""pipeline.load_artifacts_s: host seconds of step 3's reading of the step-1
artifacts back onto the card (pipeline.load_artifacts), per CLI file.

Source: the program's span `pipeline.load_artifacts`
(bfqzip_tpu_torch.utils.profiling), recorded in the traced window: its host
seconds, summed over the window, over the `cli.main` spans, one a file."""

from span_reads import per_call


def read(rec):
    value = per_call(("pipeline.load_artifacts",), "host_ms", "cli.main")
    return None if value is None else value / 1e3

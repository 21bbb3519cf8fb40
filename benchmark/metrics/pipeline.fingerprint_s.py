"""pipeline.fingerprint_s: host seconds of the content hash of the parsed reads
(pipeline._fingerprint), every call: the artifact cache's key and the one
step 1 writes into .meta.json, per CLI file.

Source: the program's span `pipeline.fingerprint`
(bfqzip_tpu_torch.utils.profiling), recorded in the traced window: its host
seconds, summed over the window, over the `cli.main` spans, one a file."""

from span_reads import per_call


def read(rec):
    value = per_call(("pipeline.fingerprint",), "host_ms", "cli.main")
    return None if value is None else value / 1e3

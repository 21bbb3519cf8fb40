"""sharded.host_span_ms: rank 0's host milliseconds of whole-batch work per sharded call.

Source: the program's spans `sharded.pad` (the batch padded to a multiple of
the ranks), `sharded.upload` (the rank's rows to its card) and
`sharded.gather` (every rank's smoothed rows gathered and copied to the
host) in parallel/global_pipeline._smooth_on, recorded on rank 0 (the
harness's process) in the traced window: their host milliseconds summed over
the window, over the call's root spans `sharded.smooth_fastq`."""

from span_reads import per_call


def read(rec):
    return per_call(("sharded.pad", "sharded.upload", "sharded.gather"), "host_ms",
                    "sharded.smooth_fastq")

"""external.merge_wait_s: host seconds that the out-of-core route's smoothing
spends blocked on the k-way merge (csrc/extmerge.cpp on host threads), per
file.

Source: the program's span `external.merge_wait`
(bfqzip_tpu_torch.utils.profiling), one each time smoothing waits for the
merged prefix, recorded in the traced window: its host seconds, summed over
the window, over the `external.smooth_fastq` spans, one a file.  A file
whose merge never held smoothing up reads 0."""

from span_reads import recorded


def read(rec):
    spans = recorded()
    files = sum(s["name"] == "external.smooth_fastq" for s in spans)
    if not files:
        return None
    return sum(s["host_ms"] for s in spans if s["name"] == "external.merge_wait") / files / 1e3

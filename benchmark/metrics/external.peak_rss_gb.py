"""external.peak_rss_gb: GB of host memory that the out-of-core files add
to the process's resident set over the window: the peak less the resident
set at the window's start.

Source: bfqzip_tpu_torch.utils.profiling.RssSampler (/proc/self/statm every
50 ms; a spike shorter than that can be missed), started and stopped around
the traced window by the entry `cli_ext`.  What the spill files keep out of
the resident set shows here."""


def read(rec):
    rss = rec.get("rss")
    if not rss:
        return None
    return (rss["peak"] - rss["start"]) / 1e9

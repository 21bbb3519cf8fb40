"""engine.copy_ms: milliseconds of host<->device copies per smooth_fastq call.

Source: the traced window's timeline (the HtoD and DtoH gpu_memcpy events
inside the window, summed, over the window's calls; copies within the card,
which the ops make, are left out).  Layer: engine.smooth_fastq, the host
wrapper, whose pageable copies of the batch in and the reads out are part of
each call."""


def read(rec):
    tl = rec.get("timeline")
    if not tl or not tl["host_copy_count"]:
        return None
    return tl["host_copy_s"] * 1e3 / rec["calls"]

"""sharded.sort_ms: milliseconds of the distributed suffix sort of one sharded call.

Source: the traced run's reported call after the window: each rank's
smooth_rank report ("sort_ms", the CUDA-event time of the program's
`sharded.sort` span, which does not wait for the card), the largest over
the ranks (the slowest rank sets the call)."""


def read(rec):
    reports = rec.get("rank_reports")
    if not reports or not all("sort_ms" in r for r in reports):
        return None
    return max(r["sort_ms"] for r in reports)

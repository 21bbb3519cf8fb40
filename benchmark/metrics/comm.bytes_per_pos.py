"""comm.bytes_per_pos: bytes handed to collectives per BWT position, one sharded call.

Source: the traced run's reported call: each rank's `sent_bytes` counter
(parallel/comm.Comm counts every byte a rank hands to a collective), summed
over the ranks, over the batch's positions (bases plus one end marker a
read).  A counter that repeats exactly from run to run of a seed."""


def read(rec):
    reports = rec.get("rank_reports")
    if not reports or not all("sent_bytes" in r for r in reports):
        return None
    return sum(r["sent_bytes"] for r in reports) / rec["positions"]

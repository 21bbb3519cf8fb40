"""codec.ratio: a file's archive bytes (its .fq.dna.rans, .fq.qs.rans and
.h.rans) over its input FASTQ's bytes; lower is better.

Source: the program's counter `pipeline.codec_streams` (one record a
stream of the last file that step 5 wrote, with its `out_bytes`), read by
the entry `cli_m3` after each file.  Every file of a run is the same input
and the coder is deterministic, so the files read alike; the last is
taken.  None where the program has no such counter."""


def read(rec):
    files = [f for f in rec.get("files", []) if f.get("archive_bytes") is not None]
    if not files or not rec.get("input_bytes"):
        return None
    return files[-1]["archive_bytes"] / rec["input_bytes"]

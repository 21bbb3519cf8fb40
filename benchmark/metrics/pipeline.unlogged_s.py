"""pipeline.unlogged_s: seconds of a CLI file that no StepLogger step covers.

Source: per file of the traced window, the file's wall seconds (host clock
around cli.main) minus the sum of the steps in its OUT.log, averaged over
the files.  That leaves the fingerprint, format_fastq, the header and .fq
writes and the CLI's own start-up, which the program does not span yet."""


def read(rec):
    files = rec.get("files")
    if not files:
        return None
    rest = [f["seconds"] - sum(p["seconds"] for p in f["phases"]) for f in files]
    return sum(rest) / len(rest)

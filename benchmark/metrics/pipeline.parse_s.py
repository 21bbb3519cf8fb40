"""pipeline.parse_s: seconds of the CLI's "read FASTQ" step per file.

Source: the program's StepLogger records (OUT.log) of each file in the
traced window, averaged over the files."""


def read(rec):
    files = rec.get("files")
    if not files:
        return None
    steps = [p["seconds"] for f in files for p in f["phases"] if p["phase"] == "read FASTQ"]
    if len(steps) != len(files):
        return None
    return sum(steps) / len(files)

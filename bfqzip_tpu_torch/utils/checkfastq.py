"""FASTQ validity checking (reference checkFASTQ.py).

Port of bfqzip_tpu/utils/checkfastq.py.  The reference checks per-record
|dna| == |qs| (checkFASTQ.py:18-32) and the file extension
(checkFASTQ.py:48-54).  The port's parser enforces the former structurally;
this wrapper reproduces the user-facing check and its CLI:

    python -m bfqzip_tpu_torch.utils.checkfastq FILE
"""

from __future__ import annotations


def check_extension(path: str) -> bool:
    return path.rsplit(".", 1)[-1] in ("fastq", "fq")


def check_fastq(path: str) -> bool:
    """True iff the file parses as FASTQ with matching dna/qs lengths."""
    if not check_extension(path):
        return False
    # imported here: io.fastq imports utils.native, and utils/__init__ imports this module
    from bfqzip_tpu_torch.io.fastq import read_fastq

    try:
        read_fastq(path, with_headers=False)
    except (ValueError, OSError):
        return False
    return True


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Check FASTQ validity")
    ap.add_argument("input", nargs="+")
    args = ap.parse_args(argv)
    ok = check_fastq(args.input[0])
    print("Valid FASTQ file!" if ok else "Invalid FASTQ file!")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())

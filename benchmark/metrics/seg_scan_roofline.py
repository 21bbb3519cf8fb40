"""seg_scan_roofline: the smoother's scans' share of their memory roofline.

Source: the traced window's timeline.  The kernel time is the summed time of
csrc/seg_scan.cu's kernels (scan_tiles, and tile_carry where float64 runs)
inside the window.  The least time is the bytes the smoother's segmented
scans need per call over the card's memory bandwidth: each scan reads its
input ([C, n_pad] of its dtype) and the flag row (1 byte a position) once
and writes its output once, (2 * C * size + 1) bytes a position.  A
mode-2 smooth runs five: run_start and last_gap (cummax, int32), the symbol
counts ([5, n] int32 sum), the presence bits (int32 or) and the
cluster word (int32 keep-left): 9 + 9 + 41 + 9 + 9 = 77 bytes a position.
Modes 0 and 3 add one int32 scan (9), mode 1 one float64 sum (17).
n_pad is the flat build's reads * (width + 1).  The share is that least time
over the measured time, in %, against 3.35 TB/s, the HBM3 bandwidth of an
H100 SXM at its 700 W power limit (NVIDIA's data sheet); the card's power
limit is printed with each run by nvidia-smi in the runs' records.
Nothing is read (None) unless the window ran exactly the five launches per
call that the byte count is reckoned for."""

HBM_BYTES_PER_S = 3.35e12
SCANS = {2: (9, 9, 41, 9, 9), 0: (9, 9, 41, 9, 9, 9), 3: (9, 9, 41, 9, 9, 9),
         1: (9, 9, 41, 9, 9, 17)}
FLAT_MAX_WINDOW = 324
KERNELS = ("scan_tiles", "tile_carry")


def read(rec):
    tl = rec.get("timeline")
    if not tl or "n_reads" not in rec:
        return None
    cfg = rec["config"]["smooth"]
    if rec["width"] + 1 > FLAT_MAX_WINDOW:
        return None
    per_pos = SCANS[cfg["mode"]]
    tiles = [v for k, v in tl["ops"].items() if "scan_tiles" in k]
    launches = sum(v["count"] for v in tiles)
    if launches != len(per_pos) * rec["calls"]:
        return None
    kernel_s = sum(v["s"] for k, v in tl["ops"].items() if any(n in k for n in KERNELS))
    n_pad = rec["n_reads"] * (rec["width"] + 1)
    bound_s = sum(per_pos) * n_pad / HBM_BYTES_PER_S * rec["calls"]
    return 100.0 * bound_s / kernel_s

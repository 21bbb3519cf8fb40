"""Read names made from a seed: CASAVA 1.8 names of a slice of a HiSeq 2000
lane.

    @<run>.<i> <instrument>:<run number>:<flowcell>:<lane>:<tile>:<x>:<y>/<read>

The lane is its tiles in order, `clusters_per_tile` reads each: the tiles
ascend through the v3 flow cell's numbering, surface, swath, then tile
(1101-1116, 1201-1216, 1301-1316, 2101-2116, ..., 2316).  Within a tile y
is non-decreasing over the tile's height and x uniform over its width, as
an instrument reports clusters scanned along the tile.  A file is n
consecutive reads of that lane from a start drawn from the seed, so it
sits in one tile or across two, with y steps of a full tile's density; i
is the read's place in the lane, from 1.  The same seed gives the same
names on every host (NumPy's generator, on the host).
"""

from __future__ import annotations

import numpy as np


def tiles(spec: dict) -> np.ndarray:
    """The lane's tile numbers in order, for the configuration's `tiles`."""
    t = spec["tiles"]
    return np.array([1000 * surface + 100 * swath + tile
                     for surface in range(1, t["surfaces"] + 1)
                     for swath in range(1, t["swaths"] + 1)
                     for tile in range(1, t["per_swath"] + 1)], dtype=np.int64)


def make(spec: dict, n: int, seed: int) -> list:
    """n header lines (bytes, '@' first, no newline) for the configuration's
    `headers` section."""
    rng = np.random.default_rng(seed)
    lane_tiles = tiles(spec)
    per_tile = spec["clusters_per_tile"]
    if n > len(lane_tiles) * per_tile:
        raise ValueError(f"{n} reads do not fit in a lane of {len(lane_tiles) * per_tile}")
    start = int(rng.integers(0, len(lane_tiles) * per_tile - n + 1))
    (x_lo, x_hi), (y_lo, y_hi) = spec["x"], spec["y"]
    y = []
    for t in range(start // per_tile, (start + max(n, 1) - 1) // per_tile + 1):
        # the tile's y, sorted uniform draws over its height from exponential
        # spacings; the file keeps those of its own reads
        at = np.cumsum(rng.standard_exponential(per_tile + 1))
        tile_y = y_lo + ((y_hi - y_lo + 1) * (at[:-1] / at[-1])).astype(np.int64)
        y.append(tile_y[max(start - t * per_tile, 0):min(start + n - t * per_tile, per_tile)])
    y = np.concatenate(y)
    x = rng.integers(x_lo, x_hi + 1, n)
    tile_of = lane_tiles[(start + np.arange(n, dtype=np.int64)) // per_tile]
    head = f"@{spec['run']}.".encode()
    mid = f" {spec['instrument']}:{spec['run_number']}:{spec['flowcell']}:{spec['lane']}:".encode()
    tail = f"/{spec['read']}".encode()
    return [b"%s%d%s%d:%d:%d%s" % (head, start + i + 1, mid, t, xi, yi, tail)
            for i, (t, xi, yi) in enumerate(zip(tile_of.tolist(), x.tolist(), y.tolist()))]

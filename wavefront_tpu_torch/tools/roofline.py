"""What a dependent voxel read costs on the card: from a whole-scene table
through L2, against from a 32x32-column window staged in shared memory.

Counterpart of `tools/roofline.py`.  The extraction probes
(`kernels/extract_probe`) carry lanes through a chain of reads in which
every read waits for the one before it; the per-iteration cost is the
slope between two iteration counts of one launch.  The rows:

  cur_extract_160, _416      the whole-scene table (160^2 x 6 and 416^2 x 7
                             channels), lanes spread over the scene
  cur_coherent_160, _416     the same read with 8 channels and the lanes
                             of the win rows: the direct comparison
  win_extract_u8, _nw169     the consensus window of a 5x5 and a 13x13
                             window scene, 8 channels, lanes of a group
                             clustered within 32 voxels (the sorted,
                             coherent case)
  win_extract_u8_rows{8,16,32}   the same by group size

each for one group (what the TPU tool's single tile is) and for enough
groups to fill the card.  `ns_per_iter` is the slope of the launch,
`ns_per_lane_iter` that over the lanes in flight.  The tracer's own
per-crossing slope is `tools/event_lab.py`'s `event` rows.

    python -m wavefront_tpu_torch.tools.roofline [--quick]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from wavefront_tpu_torch.kernels.extract_probe import extract_cur, extract_win
from wavefront_tpu_torch.tools._timing import (
    FILL_GROUPS,
    emit,
    require_card,
    time_slope,
)

SPREAD = 32


def _lanes(rng, groups, rows, hi_x, hi_z, spread=None):
    """(cx, cz) on the card: uniform over the scene, or each group
    clustered within `spread` voxels of its own base."""
    shape = (groups, rows, 128)
    if spread is None:
        cx, cz = rng.integers(0, hi_x, shape), rng.integers(0, hi_z, shape)
    else:
        bx = rng.integers(0, hi_x - spread, (groups, 1, 1))
        bz = rng.integers(0, hi_z - spread, (groups, 1, 1))
        cx = bx + rng.integers(0, spread, shape)
        cz = bz + rng.integers(0, spread, shape)
    return tuple(torch.as_tensor(a.astype(np.int32), device="cuda")
                 for a in (cx, cz))


def _row(name, fn, groups, rows, lo, hi, **fields):
    per_iter = time_slope(lambda iters: (lambda: fn(iters)), lo, hi)
    return {"row": name, "groups": groups, "rows": rows,
            "ns_per_iter": per_iter * 1e6,
            "ns_per_lane_iter": per_iter * 1e6 / (groups * rows * 128),
            "iters": [lo, hi], **fields}


def rows(quick: bool = False, lo: int = 256, hi: int = 2048) -> list:
    """The lab's rows, measured on the card."""
    rng = np.random.default_rng(0)

    def u8(shape):
        return torch.as_tensor(rng.integers(0, 255, shape).astype(np.uint8),
                               device="cuda")

    out = []
    scenes = [(160, 5, 6)] + ([] if quick else [(416, 13, 7)])
    for groups in (1, FILL_GROUPS):
        for g, nw, nc in scenes:
            table = u8((nc, g, g))
            cx, cz = _lanes(rng, groups, 8, g, g)
            out.append(_row(f"cur_extract_{g}",
                            lambda it: extract_cur(table, cx, cz, it),
                            groups, 8, lo, hi, channels=nc))
            table8 = u8((8, g, g))
            tw = u8((nw * nw, 64, 128))
            cx, cz = _lanes(rng, groups, 8, nw * 32, nw * 32, SPREAD)
            out.append(_row(f"cur_coherent_{g}",
                            lambda it: extract_cur(table8, cx, cz, it),
                            groups, 8, lo, hi, channels=8))
            name = "win_extract_u8" + ("" if nw == 5 else f"_nw{nw * nw}")
            out.append(_row(name,
                            lambda it: extract_win(tw, cx, cz, it, nw, nw),
                            groups, 8, lo, hi, channels=8))
        tw = u8((25, 64, 128))
        for r in (8, 16, 32):
            cx, cz = _lanes(rng, groups, r, 160, 160, SPREAD)
            out.append(_row(f"win_extract_u8_rows{r}",
                            lambda it: extract_win(tw, cx, cz, it, 5, 5),
                            groups, r, lo, hi, channels=8))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="skip the 416^2 scene")
    args = ap.parse_args(argv)
    require_card()
    emit(rows(args.quick))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

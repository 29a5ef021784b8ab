"""Bounce-fusion probe: how a tile of consecutive ray slots decays across
bounces when nothing re-sorts it.

Counterpart of `tools/fusion_probe.py`.  A fused bounce (one launch that
traces and shades a block of rays through several bounces, or a CUDA
graph of the bounce loop without the per-bounce sort) keeps each ray in
its slot after bounce 0's sort: a block's cost in the next bounce is then
set by its own rays, by the share of them still alive (dead lanes idle in
their warp) and by the spread of the 32^3 windows their next segments
start in (each window more is more of the grid a block's rays touch).

The probe renders the headline frame (`headline.headline_setup`) through
`render_frame` with the bounce sort on its coherence key (sort_type 1, no
compaction, so every slot stays in place) and reads the rays each bounce
hands the tracer.  Per tile of `--tile` consecutive slots (2048, the JAX
tool's, and 256, K1's block) it reports the alive fraction (mean and
median over tiles) and the distinct windows of the alive rays' origins
(mean, p95 and max over the tiles with a live ray), at three stages, the
JAX tool's:
  after-b0-scatter   bounce 1's rays in bounce 0's sorted order
                     (sort_bounces=(0,): the fused regime's layout);
  after-b1-scatter   bounce 2's rays, still in bounce 0's order;
  RE-SORTED          bounce 1's rays after bounce 1's own sort
                     (sort_bounces=(0, 1): what the wavefront loop does).
With tools/sort_sweep.py's `none` and `b1` rows (the frame's cost of
tracing in a stale order) it is the evidence for fusing bounces.

    python -m wavefront_tpu_torch.tools.fusion_probe [--tile 2048 256] \
        [--width 1920 --height 1080] [--device cuda]

Without a card it exits unless given `--device cpu`, which runs the
kernels' plain versions.
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from wavefront_tpu_torch.headline import headline_setup
from wavefront_tpu_torch.kernels.window_trace import W, window_trace
from wavefront_tpu_torch.render.renderer import render_frame
from wavefront_tpu_torch.tools import _sweep
from wavefront_tpu_torch.tools._timing import emit

STAGES = (("after-b0-scatter (fused b1 trace layout)", (0,), 1),
          ("after-b1-scatter (fused b2 trace layout)", (0,), 2),
          ("after-b0-scatter, RE-SORTED (wavefront)", (0, 1), 1))


def traced_rays(scene, settings, basis, prefs, sort_bounces) -> list:
    """(o, d) that each bounce of a 3-bounce headline frame hands the
    tracer, under the sort schedule `sort_bounces`, every slot kept."""
    arrays = scene.get_arrays()
    seen = []

    def spy(a, o, d, events):
        seen.append((o, d))
        return window_trace(a, o, d, events)

    render_frame(arrays, basis.eye, basis.front, basis.right, basis.up, 0,
                 settings=settings.replace(num_bounces=3, compaction=False,
                                           sort_bounces=sort_bounces),
                 nee_type=prefs.nee_type, sort_type=1, trace=spy,
                 use_entities=bool(scene._entities))
    return seen


def windows(arrays, o, d):
    """(each ray's 32^3 window index, alive mask): the window of the cell
    its origin lies in, clipped to the grid."""
    gx, gy, gz = arrays.grid.shape
    go = arrays.grid_origin
    nwx, nwz = math.ceil(gx / W), math.ceil(gz / W)

    def cell(c, g, dim):
        return torch.floor(c - float(g)).clamp(0, dim - 1).to(torch.int64)

    cx, cy, cz = cell(o.x, go[0], gx), cell(o.y, go[1], gy), \
        cell(o.z, go[2], gz)
    win = ((cy // W) * nwx + cx // W) * nwz + cz // W
    alive = (d.x != 0) | (d.y != 0) | (d.z != 0)
    return win, alive


def tile_stats(win, alive, tile: int, stage: str) -> dict:
    n = win.shape[0]
    tid = torch.arange(n, device=win.device) // tile
    tiles = int(tid[-1]) + 1
    size = torch.bincount(tid, minlength=tiles).double()
    frac = (torch.bincount(tid, weights=alive.double(), minlength=tiles)
            / size).cpu().numpy()
    nwin = int(win.max()) + 1
    uniq = torch.unique(tid[alive] * nwin + win[alive])
    nw = torch.bincount(uniq // nwin, minlength=tiles).cpu().numpy()
    live = nw > 0
    return {
        "stage": stage, "tile": tile, "tiles": tiles,
        "live_tiles": int(live.sum()),
        "alive_frac_mean": float(frac.mean()),
        "alive_frac_p50": float(np.median(frac)),
        "windows_per_tile_mean": float(nw[live].mean()) if live.any() else 0.0,
        "windows_per_tile_p95": float(np.percentile(nw[live], 95))
        if live.any() else 0.0,
        "windows_per_tile_max": int(nw.max()),
    }


def probe(scene, settings, basis, prefs, tiles=(2048, 256)) -> list:
    arrays = scene.get_arrays()
    runs = {}
    out = []
    for stage, sched, bounce in STAGES:
        if sched not in runs:
            runs[sched] = traced_rays(scene, settings, basis, prefs, sched)
        win, alive = windows(arrays, *runs[sched][bounce])
        for tile in tiles:
            out.append(tile_stats(win, alive, tile, stage))
    return out


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--tile", type=int, nargs="+", default=[2048, 256])
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--device", default="cuda",
                   help="cuda, or cpu for the kernels' plain versions")
    args = p.parse_args(argv)
    dev = _sweep.device_of(args.device)
    scene, settings, basis, prefs = headline_setup(args.width, args.height,
                                                   device=dev)
    return emit(probe(scene, settings, basis, prefs, args.tile), dev)


if __name__ == "__main__":
    main()

"""Per-launch times of the tracer (K1) and the fused shade (K2) at the
headline frame's shapes, to compare two trees of the port on one card.

    python wavefront_tpu_torch/tools/kernel_times.py [--root DIR]
        [--lamps L] [--reps N]

DIR is a checkout whose `wavefront_tpu_torch` package is timed (default:
the one this file belongs to); it builds its own kernels under DIR.  Run
the file as a script: under `python -m` the package of the current
directory is imported before DIR can be put first, and the tool stops.
On the headline scene (1920x1080), with the bounce-0 rays sorted as the
renderer sorts them and the bounce-1 rays the shade makes from them, each
kernel runs `reps` times back to back between CUDA events.  With `--lamps
L` the scene also holds the first L lamp voxels of the general frame's
lattice (six light prims each; up to 41 keep the set dense), to time the
shade at a larger light set.  One JSON line per bounce, with the card's
name and power limit, the tree's root and the light set's size.  Compare
two trees within one machine, in turns (A, B, B, A).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))),
        help="checkout holding the wavefront_tpu_torch package to time")
    ap.add_argument("--lamps", type=int, default=0,
                    help="lamp voxels of the lattice added to the scene")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import torch

    import wavefront_tpu_torch
    if not os.path.abspath(wavefront_tpu_torch.__file__).startswith(
            os.path.join(root, "")):
        raise SystemExit(
            f"kernel_times: the package was imported from "
            f"{wavefront_tpu_torch.__file__}, not from {root}; run this file "
            "as a script (python wavefront_tpu_torch/tools/kernel_times.py)")
    from wavefront_tpu_torch.core.config import WorldSettings
    from wavefront_tpu_torch.core.vec3 import V3
    from wavefront_tpu_torch.headline import (
        ASSETS,
        build_scene,
        headline_setup,
        lamp_lattice,
    )
    from wavefront_tpu_torch.kernels.shade import prep_shade_tables, shade_pass
    from wavefront_tpu_torch.kernels.window_trace import (
        auto_events,
        window_trace,
    )
    from wavefront_tpu_torch.render.renderer import coherence_sort
    from wavefront_tpu_torch.render.scene import VoxelScene
    from wavefront_tpu_torch.render.wavefront import raygen_soa
    from wavefront_tpu_torch.tools._timing import card, require_card, time_ms
    from wavefront_tpu_torch.world.blocks import BlockRegistry

    require_card()
    name, limit = card()
    scene, settings, basis, _ = headline_setup(1920, 1080, 4, device="cuda")
    if args.lamps:
        registry = BlockRegistry.load(ASSETS)
        grid, origin = build_scene(registry, WorldSettings())
        for cell in lamp_lattice(grid, registry)[:args.lamps]:
            grid[cell] = registry.block_idx("lamp")
        scene = VoxelScene(registry, grid, origin, max_light_prims=256,
                           device="cuda")
    arrays = scene.get_arrays()
    tables = prep_shade_tables(arrays.atlas_packed, arrays.lights)
    w, h = settings.render_width, settings.render_height
    n = w * h
    o, d, rid = raygen_soa(basis.eye, basis.front, basis.right, basis.up,
                           w, h, device="cuda")
    tp = V3(*(torch.ones(n, device="cuda") for _ in range(3)))
    rad = V3(*(torch.zeros(n, device="cuda") for _ in range(3)))
    events = auto_events(*arrays.grid.shape)
    for b in range(2):
        o, d, tp, rad, rid = coherence_sort(arrays, o, d, tp, rad, rid)
        pa, pb, t = window_trace(arrays, o, d, events)
        args_ = (tables, arrays.grid_origin, o, d, pa, pb, t, tp, rad, rid,
                 b, b, arrays.lights.num_prims)
        row = {
            "root": root, "bounce": b, "rays": n,
            "light_prims": int(arrays.lights.num_prims),
            "light_nodes": tables.m_nodes,
            "alive": int(((d.x != 0) | (d.y != 0) | (d.z != 0)).sum()),
            "window_trace_ms": time_ms(
                lambda: window_trace(arrays, o, d, events), args.reps),
            "shade_ms": time_ms(lambda: shade_pass(*args_, nee_type=1),
                                args.reps),
            "card": name, "power_limit": limit}
        print(json.dumps(row), flush=True)
        o, d, tp, rad = (V3(*(c.contiguous() for c in v))
                         for v in shade_pass(*args_, nee_type=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

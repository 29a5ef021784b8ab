"""Tracer occupancy: where K1's lanes spend their steps on real ray sets.

Counterpart of `tools/occupancy.py`.  The TPU kernel serializes events
over tiles of rays and stalls lanes whose window is not resident; K1 runs
one ray a thread, so a warp (32 consecutive ray slots) runs as long as its
longest ray, and a block of 256 threads (`csrc/window_trace.cu`) holds its
SM slot as long as its longest warp.  Per workload:

  steps           per ray, fine voxel crossings plus empty-space skips,
                  from the tracer's plain march (`trace_plain` stats, as
                  `kernel_times.py` counts them for K1's bound): their
                  mean over live rays, p95 and max;
  warp_occupancy  sum(steps) / (32 * max steps), summed over every group
                  of 32 consecutive slots: the share of a warp's lane-steps
                  that march (1: every lane busy until the warp ends);
  block_occupancy the same over K1's 256-thread blocks;
  ms              K1 on the set (CUDA events over 10 calls on the card,
                  the plain march's host time on the CPU), and Mrays/s.

Workloads (the JAX tool's):
  primary    the headline camera's raygen rays, 1920x1080, pixel order;
  secondary  hemisphere rays from the primary hits (seeded from
             `numpy.random.default_rng(0)` as the JAX tool draws them),
             in the coherence-key order the frame's bounce sort gives its
             rays before it traces them;
  streamed   the game layer's streamed window (`headline.streamed_setup`,
             416x96x416 voxels) with its camera's 1024x1024 raygen rays.

The JAX tool's `--tiles`, `--windows` and `--phases` pick the TPU
kernel's tile, resident windows and phases; here the lane groups are the
warp and K1's block, fixed by the card and the kernel.

    python -m wavefront_tpu_torch.tools.occupancy [--only primary,secondary] \
        [--quick] [--width 1920 --height 1080] [--device cuda]

`--quick` leaves out `streamed`.  Without a card it exits unless given
`--device cpu`, which runs the tracer's plain version.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from wavefront_tpu_torch.core.config import RenderSettings
from wavefront_tpu_torch.core.vec3 import V3
from wavefront_tpu_torch.headline import headline_setup, streamed_setup
from wavefront_tpu_torch.kernels.window_trace import auto_events, window_trace
from wavefront_tpu_torch.render.intersect import trace_plain, unpack_hits
from wavefront_tpu_torch.render.renderer import bounce_sort_key
from wavefront_tpu_torch.render.wavefront import raygen_soa
from wavefront_tpu_torch.tools import _sweep
from wavefront_tpu_torch.tools._timing import emit, time_ms

WORKLOADS = ("primary", "secondary", "streamed")
WARP, BLOCK = 32, 256


def lane_occupancy(steps: torch.Tensor, group: int) -> float:
    """sum(steps) / (group * max steps) over groups of `group` consecutive
    slots (the last one padded with idle lanes), summed over groups."""
    pad = (-steps.numel()) % group
    g = torch.nn.functional.pad(steps.to(torch.int64), (0, pad)).view(
        -1, group)
    return float(g.sum()) / max(float(g.max(1).values.sum()) * group, 1.0)


def hemisphere(o: V3, d: V3, pa, pb, t, seed: int = 0):
    """The JAX tool's secondary rays: from each hit point (nudged 1e-3 off
    its face) a direction drawn uniformly on the sphere and flipped into
    the face's hemisphere; a miss gives a dead ray (zero direction)."""
    dev = o.x.device
    hit = unpack_hits(pa, pb, t)
    n = o.x.shape[0]
    oo, dd = o.stack(), d.stack()
    hp = oo + dd * t[:, None]
    axis = (hit.face >> 1).to(torch.int64)
    sgn = ((hit.face & 1) * 2 - 1).to(torch.float32)
    nrm = torch.zeros_like(oo)
    nrm[torch.arange(n, device=dev), axis] = sgn
    rng = np.random.default_rng(seed)
    v = torch.as_tensor(rng.standard_normal((n, 3)).astype(np.float32),
                        device=dev)
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    dot = (v * nrm).sum(-1, keepdim=True)
    v = torch.where(dot < 0, v - 2 * dot * nrm, v)
    o2 = hp + nrm * 1e-3
    d2 = torch.where(hit.hit[:, None], v, torch.zeros_like(v))
    return V3.from_array(o2), V3.from_array(d2)


def coherence_order(arrays, o: V3, d: V3):
    """The rays in the order of the frame's bounce sort at the default
    settings (the coherence key, stable)."""
    key = bounce_sort_key(arrays, RenderSettings(), 0, o, d)
    perm = torch.sort(key, stable=True).indices
    return (o.map(lambda c: c[perm].contiguous()),
            d.map(lambda c: c[perm].contiguous()))


def measure(workload: str, arrays, o: V3, d: V3) -> tuple:
    """(the workload's row, the plain march's (pa, pb, t))."""
    dev = o.x.device
    events = auto_events(*arrays.grid.shape)
    stats = {}
    pa, pb, t = trace_plain(arrays, o, d, events, stats=stats)
    steps = stats["per_ray"]
    live = (d.x != 0) | (d.y != 0) | (d.z != 0)
    ls = steps[live].to(torch.float64)
    n_live = int(live.sum())
    ms = time_ms(lambda: window_trace(arrays, o, d, events),
                 10 if dev.type == "cuda" else 1, dev)
    return {
        "workload": workload, "rays": int(o.x.shape[0]), "live_rays": n_live,
        "grid": list(arrays.grid.shape), "ms": ms,
        "mrays_per_sec": o.x.shape[0] / ms / 1e3,
        "fine": stats["fine"], "skips": stats["skips"],
        "steps_per_live_ray": float(ls.mean()) if n_live else 0.0,
        "steps_p95": float(torch.quantile(ls, 0.95)) if n_live else 0.0,
        "steps_max": int(steps.max()),
        "warp_occupancy": lane_occupancy(steps, WARP),
        "block_occupancy": lane_occupancy(steps, BLOCK),
        "truncated": int(((pa >> 22) & 1).sum()),
    }, (pa, pb, t)


def survey(width: int = 1920, height: int = 1080, dev="cuda",
           only=WORKLOADS, headline=None, streamed=None) -> list:
    """The rows of the workloads in `only`.  headline: (scene, basis) of
    the headline frame, streamed: (scene, basis) of the streamed window,
    built here when not given."""
    dev = torch.device(dev)
    out = []
    if "primary" in only or "secondary" in only:
        if headline is None:
            scene, _, basis, _ = headline_setup(width, height, device=dev)
        else:
            scene, basis = headline
        arrays = scene.get_arrays()
        o, d, _ = raygen_soa(basis.eye, basis.front, basis.right, basis.up,
                             width, height, device=dev)
        row, hits = measure("primary", arrays, o, d)
        if "primary" in only:
            out.append(row)
        if "secondary" in only:
            o2, d2 = coherence_order(arrays, *hemisphere(o, d, *hits))
            out.append(measure("secondary", arrays, o2, d2)[0])
    if "streamed" in only:
        if streamed is None:
            scene, _, _, basis, _ = streamed_setup(1024, 1024, 6, device=dev)
        else:
            scene, basis = streamed
        o, d, _ = raygen_soa(basis.eye, basis.front, basis.right, basis.up,
                             1024, 1024, device=dev)
        out.append(measure("streamed", scene.get_arrays(), o, d)[0])
    return out


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--only", default="",
                   help="comma-separated workloads: primary, secondary, "
                        "streamed")
    p.add_argument("--quick", action="store_true",
                   help="leave out the streamed window")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--device", default="cuda",
                   help="cuda, or cpu for the tracer's plain version")
    args = p.parse_args(argv)
    dev = _sweep.device_of(args.device)
    only = [w for w in WORKLOADS
            if (not args.only or w in args.only.split(","))
            and not (args.quick and w == "streamed")]
    return emit(survey(args.width, args.height, dev, only), dev)


if __name__ == "__main__":
    main()

"""The voxel tracer: the CUDA kernel `csrc/window_trace.cu`, its plain
PyTorch version (`render.intersect.trace_plain`), the per-ray event budget
and the bounce-sort coherence key.

Replaces the TPU kernel `wavefront_tpu/kernels/window_trace.py::_kernel`
(called by `window_trace()`).  The TPU kernel's 32^3 window tables,
one-hot extraction and tile schedules exist because a TPU kernel cannot
gather; the CUDA kernel walks the dense aux grid (`scene.aux_grid`: class
bits and empty-space distance) one thread per ray and reads its bytes
directly, skipping empty cubes as the JAX package's DDA does.  What it
computes is the same: each ray's first voxel-face crossing under the
mesher face rule, in packed hit words (`render.intersect.pack_hits`),
with rays that exhaust their budget reported as misses with bit 22 set.

Bound on the card: 36 bytes per ray cross device memory (origin and
direction in, pa/pb/t out); the grid and aux grid stay in L2.  The march
is a chain of dependent steps, one byte load each, and the kernel is
bound by the instructions of its steps (see the source note in the .cu
file and PERF.md).
"""

from __future__ import annotations

import math
import types

import torch

from wavefront_tpu_torch.core.config import EPSILON_BLOCK, T_MAX
from wavefront_tpu_torch.core.vec3 import V3
from wavefront_tpu_torch.kernels import _build
from wavefront_tpu_torch.render.intersect import (
    AIR_ID,
    MAX_GRID,
    TRUNCATED_BIT,
    trace_plain,
    unpack_hits,
)

W = 32  # coherence-key window edge, in voxels


def auto_events(gx: int, gy: int, gz: int) -> int:
    """Default per-ray step budget for a (gx, gy, gz) grid: 2048, or ten
    times the grid diameter when three diameters exceed 2048 (the JAX
    package's rule).  A DDA walk crosses at most gx+gy+gz boundaries
    inside the grid, so this budget never truncates a ray there."""
    diam = gx + gy + gz
    return 2048 if 3 * diam <= 2048 else 10 * diam


def coherence_key(ox, oy, oz, dx, dy, dz, gx: int, gy: int, gz: int):
    """Bounce-sort key (int64 holding an unsigned 32-bit value): dead rays
    last (bit 31), then the current 32^3 window, direction class and fine
    position cell.  Positions are grid-local.  The image does not depend
    on the key: it only orders rays so that a warp marches together."""
    nwx, nky, nwz = (math.ceil(g / W) for g in (gx, max(gy, 1), gz))
    dead = (dx == 0.0) & (dy == 0.0) & (dz == 0.0)
    cw = 1.0 / W

    def q(v, hi):
        return v.clamp(0.0, hi).to(torch.int64)

    wx = q(ox * cw, nwx - 1.0)
    wy = q(oy * cw, nky - 1.0)
    wz = q(oz * cw, nwz - 1.0)
    win = torch.clamp_max((wy * nwx + wx) * nwz + wz, 511)
    dyq = q((dy + 1.0) * 3.99, 7.0)
    ang = torch.atan2(dz, dx)
    angq = q((ang + 3.1416) * 10.14, 63.0)
    xq = q(ox * 0.25, 127.0) & 7
    yq = q(oy * 0.25, 127.0) & 3
    zq = q(oz * 0.25, 127.0) & 7
    return ((dead.to(torch.int64) << 31) | (win << 22) | (dyq << 19)
            | (angq << 13) | (xq << 10) | (zq << 7) | (yq << 5))


_LAUNCH = _build.Launcher("window_trace", "wt_trace", "ppppppppiiifffiiffppp",
                         "window_trace")


def window_trace(scene, origin: V3, direction: V3, max_events: int, *,
                 grid_origin=None, t_min: float = EPSILON_BLOCK,
                 t_max: float = T_MAX, air_id: int = AIR_ID,
                 with_truncated: bool = False, packed_hits: bool = True):
    """First face crossing of every ray; returns packed (pa, pb, t).

    scene: render.scene.SceneArrays (its `grid`, `aux_grid` and
    `grid_origin`, which `grid_origin` overrides when given);
    origin/direction: V3 of (N,) float32 world-space components (a zero
    direction is an inactive ray).  A skip counts as one of the
    `max_events` steps.  CPU tensors take `trace_plain`; CUDA tensors
    launch the kernel or raise.  Grids larger than the hit words hold
    (MAX_GRID) raise.

    The JAX package's options: hits count between t_min and t_max; a
    miss names `air_id` as its owner; with_truncated also returns the
    (N,) bool mask of rays that ran out of steps; packed_hits=False
    returns `unpack_hits`' VoxelHit in place of the words (the JAX
    package's default; every caller here takes the words)."""
    if any(g > m for g, m in zip(scene.grid.shape, MAX_GRID)):
        raise ValueError(f"window_trace: grid {tuple(scene.grid.shape)} "
                         f"exceeds the hit-word limits {MAX_GRID}")
    if grid_origin is not None:
        scene = types.SimpleNamespace(
            grid=scene.grid, aux_grid=scene.aux_grid,
            grid_origin=[int(g) for g in grid_origin])
    pa, pb, t = _trace(scene, origin, direction, max_events, t_min, t_max)
    if air_id != AIR_ID:
        miss = (pa & 1) == 0
        pa = torch.where(miss, (pa & ~(255 << 14)) | (int(air_id) << 14), pa)
    out = (pa, pb, t) if packed_hits else unpack_hits(pa, pb, t)
    if with_truncated:
        return out, ((pa >> TRUNCATED_BIT) & 1) != 0
    return out


def _trace(scene, origin: V3, direction: V3, max_events: int,
           t_min: float, t_max: float):
    """(pa, pb, t) of the rays: `trace_plain` for CPU tensors, the kernel
    for CUDA ones."""
    comps = (*origin, *direction)
    if comps[0].device.type == "cpu":
        return _build.plain("window_trace", trace_plain, scene, origin,
                            direction, max_events, t_min=t_min, t_max=t_max)
    dev = comps[0].device
    n = comps[0].shape[0]
    for c in comps:
        if (c.device != dev or c.dtype != torch.float32 or c.dim() != 1
                or c.shape[0] != n or not c.is_contiguous()):
            raise ValueError("window_trace: origin/direction must be six "
                             "contiguous (N,) float32 tensors on one device")
    grid, aux = scene.grid, scene.aux_grid
    for x in (grid, aux):
        if x.device != dev or x.dtype != torch.uint8 or x.dim() != 3 \
                or not x.is_contiguous() or x.shape != grid.shape:
            raise ValueError("window_trace: grid and aux_grid must be "
                             "contiguous 3-D uint8 tensors of one shape on "
                             "the rays' device")
    gx, gy, gz = grid.shape
    pa = torch.empty(n, dtype=torch.int32, device=dev)
    pb = torch.empty(n, dtype=torch.int32, device=dev)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    go = scene.grid_origin
    _LAUNCH(dev.index, *(c.data_ptr() for c in comps), grid.data_ptr(),
            aux.data_ptr(), gx, gy, gz, float(go[0]), float(go[1]),
            float(go[2]), n, int(max_events), float(t_min), float(t_max),
            pa.data_ptr(), pb.data_ptr(), t.data_ptr())
    window_trace.launches += 1
    _build.check_outputs("window_trace", t)
    return pa, pb, t


window_trace.launches = 0

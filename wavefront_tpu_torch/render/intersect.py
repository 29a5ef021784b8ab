"""Intersection: the voxel hit record, its packed form, the plain PyTorch
tracer that the CUDA tracer (`kernels/window_trace.py`) is held against
(and `dda_trace`, the same march with the JAX package's arguments), and
the closest-hit sweep over the dynamic entities' triangles.

The reference intersects rays with meshed voxel faces through hardware ray
queries (raytrace.rs:366-400).  Here, as in the JAX package, the
intersector is a 3-D DDA (Amanatides & Woo) over the dense uint8 grid, and
the mesher's face rule (chunk.rs:222-287) is evaluated at every voxel
boundary the ray crosses:

  * entering:  the face of `nxt` toward `cur` exists iff `nxt` is not
    completely transparent and `cur` is translucent; owner = nxt;
  * exiting:   the face of `cur` toward `nxt` exists iff `cur` is not
    completely transparent and `nxt` is translucent; owner = cur;
  * when both coplanar faces exist the entering face wins; on equal
    crossing times x is taken before y before z;
  * voxels outside the grid read as air (id 255).

The march reads an aux grid (`make_aux_grid`, built once per grid): each
voxel's class bits and its Chebyshev distance to the nearest voxel that
is not completely transparent.  From a voxel at distance d >= 2 the march
jumps to the exit of the radius-(d-1) cube around it, where no face can
lie (the JAX package's empty-space skip).

Hit words (`pack_hits`, the layout of the reference's tracer kernel):
  pa: hit(0) | entered(1) | face(2..4) | vy+2(5..13) | owner(14..21)
      | truncated(22)
  pb: vx+2(0..9) | vz+2(10..19)
  t:  ray parameter of the hit (3e38 on a miss)
"""

from __future__ import annotations

import types
from typing import NamedTuple

import numpy as np
import torch

from wavefront_tpu_torch.core.config import EPSILON_BLOCK, T_MAX
from wavefront_tpu_torch.core.vec3 import V3
from wavefront_tpu_torch.kernels.tri_sweep import tri_sweep
from wavefront_tpu_torch.utils import spans

_F32 = torch.float32
_I32 = torch.int32

INF_T = 3.0e38           # t of a miss, larger than any real hit
NUDGE = 1e-4             # start nudge along the ray, as the reference
AIR_ID = 255             # id read outside the grid
CLASS_TRANSPARENT = 1    # class bit 0: completely transparent
CLASS_TRANSLUCENT = 2    # class bit 1: translucent
TRUNCATED_BIT = 22       # pa bit: the ray exhausted its step budget
MAX_SKIP = 31            # clamp of the aux grid's distance (bits 2-6)
SKIP_NUDGE = 1e-4        # a skip lands this far before the cube's exit
# largest grid the hit words hold (vx+2 in 10 bits, vy+2 in 9 bits), the
# JAX package's window-pack limits
MAX_GRID = (1020, 507, 1020)


class VoxelHit(NamedTuple):
    """SoA trace result, one entry per ray."""

    hit: torch.Tensor       # bool
    t: torch.Tensor         # f32 ray parameter of the hit
    owner: torch.Tensor     # int32 block id owning the hit face
    face: torch.Tensor      # int32 in [0,6): LEFT RIGHT DOWN UP BACK FRONT
    vx: torch.Tensor        # int32 owner voxel, grid-local
    vy: torch.Tensor
    vz: torch.Tensor
    entered: torch.Tensor   # bool: True = front face (ray enters owner)


def make_aux_grid(grid, transparent, translucent,
                  max_skip: int = MAX_SKIP) -> np.ndarray:
    """The tracer's aux grid of a (gx, gy, gz) uint8 block grid, as uint8:
    bits 0-1 the voxel's class (CLASS_TRANSPARENT | CLASS_TRANSLUCENT),
    bits 2-6 its Chebyshev distance to the nearest voxel that is not
    completely transparent, clamped to `max_skip` (at most MAX_SKIP).

    The JAX package's `render.intersect.make_aux_grid` (which returns the
    same values as int32): the distance grows by one per 3^3 dilation of
    the solid mask, separable per axis.  Built once per grid; an edit
    refreshes it around the edit (`update_aux_region`, `refresh_aux_box`)."""
    if not 0 <= max_skip <= MAX_SKIP:
        raise ValueError(f"make_aux_grid: max_skip {max_skip} does not fit "
                         f"the aux grid's bits (0..{MAX_SKIP})")
    grid = np.asarray(grid)
    transparent = np.asarray(transparent, bool)
    translucent = np.asarray(translucent, bool)
    cls = (transparent[grid].astype(np.uint8) * CLASS_TRANSPARENT
           + translucent[grid].astype(np.uint8) * CLASS_TRANSLUCENT)
    reach = ~transparent[grid]
    dist = np.full(grid.shape, max_skip, np.uint8)
    dist[reach] = 0

    def dilate(m):
        r = m.copy()
        r[1:, :, :] |= m[:-1, :, :]
        r[:-1, :, :] |= m[1:, :, :]
        m = r.copy()
        r[:, 1:, :] |= m[:, :-1, :]
        r[:, :-1, :] |= m[:, 1:, :]
        m = r.copy()
        r[:, :, 1:] |= m[:, :, :-1]
        r[:, :, :-1] |= m[:, :, 1:]
        return r

    for d in range(1, max_skip):
        if reach.all():
            break
        reach = dilate(reach)
        dist[reach & (dist == max_skip)] = d
    return cls | (dist << 2)


def refresh_aux_box(grid, aux, transparent, translucent, lo, hi,
                    max_skip: int = MAX_SKIP, in_place: bool = False):
    """The aux grid recomputed exactly over the box [lo, hi) of `grid`
    (grid-local corners); returns the result, a copy of `aux` unless
    `in_place`, when `aux` itself is written and returned.

    A voxel's distance depends only on the solids within `max_skip` of
    it, so make_aux_grid of the box padded by `max_skip`, written back
    over the box alone, is exact (the JAX package's
    `render.intersect.refresh_aux_box`).  The streamed window's shift
    refreshes its entered slabs this way (`scene.shift_refresh_aux`)."""
    grid = np.asarray(grid)
    lo = np.asarray(lo, np.int64)
    hi = np.asarray(hi, np.int64)
    plo = np.maximum(lo - max_skip, 0)
    phi = np.minimum(hi + max_skip, np.array(grid.shape))
    sub = make_aux_grid(grid[plo[0]:phi[0], plo[1]:phi[1], plo[2]:phi[2]],
                        transparent, translucent, max_skip)
    out = aux if in_place else np.array(aux)
    out[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]] = sub[
        tuple(slice(int(a - p), int(b - p)) for a, b, p in zip(lo, hi, plo))]
    return out


def update_aux_region(grid, aux, transparent, translucent, pos,
                      max_skip: int = MAX_SKIP):
    """The aux grid after a one-voxel edit of `grid` at grid-local `pos`:
    a copy of `aux` with the cube of radius `max_skip` around `pos`
    recomputed from the cube of radius 2 * max_skip + 1 around it (every
    solid that reaches a voxel of the inner cube lies in the outer one),
    so equal to make_aux_grid of the edited grid (the JAX package's
    `render.intersect.update_aux_region`).  `aux_box(pos, shape)` gives
    the inner cube, the part that may change."""
    grid = np.asarray(grid)
    pos = np.asarray(pos, np.int64)
    shape = np.array(grid.shape)
    r = 2 * max_skip + 1
    lo = np.maximum(pos - r, 0)
    hi = np.minimum(pos + r + 1, shape)
    sub = make_aux_grid(grid[lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]],
                        transparent, translucent, max_skip)
    ilo, ihi = aux_box(pos, shape, max_skip)
    out = np.array(aux)
    out[ilo[0]:ihi[0], ilo[1]:ihi[1], ilo[2]:ihi[2]] = sub[
        tuple(slice(int(a - l), int(b - l)) for a, b, l in zip(ilo, ihi, lo))]
    return out


def aux_box(pos, shape, max_skip: int = MAX_SKIP):
    """(lo, hi) grid-local corners of the part of the aux grid that a
    one-voxel edit at `pos` can change: the cube of radius `max_skip`
    around it, clipped to a grid of `shape`."""
    pos = np.asarray(pos, np.int64)
    return (np.maximum(pos - max_skip, 0),
            np.minimum(pos + max_skip + 1, np.asarray(shape, np.int64)))


def pack_hits(vox: VoxelHit):
    """VoxelHit -> (pa, pb, t) int32/int32/f32 words (layout above)."""
    pa = (
        vox.hit.to(_I32)
        | (vox.entered.to(_I32) << 1)
        | (vox.face.to(_I32) << 2)
        | ((vox.vy + 2).clamp(0, 511).to(_I32) << 5)
        | ((vox.owner.to(_I32) & 255) << 14)
    )
    pb = (vox.vx + 2).clamp(0, 1023).to(_I32) | (
        (vox.vz + 2).clamp(0, 2 ** 20 - 1).to(_I32) << 10)
    return pa, pb, vox.t


def unpack_hits(pa, pb, t) -> VoxelHit:
    """(pa, pb, t) -> VoxelHit.  Both words are non-negative, so the
    arithmetic right shift of int32 is the logical one."""
    return VoxelHit(
        hit=(pa & 1) != 0,
        t=t,
        owner=(pa >> 14) & 255,
        face=(pa >> 2) & 7,
        vx=(pb & 1023) - 2,
        vy=((pa >> 5) & 511) - 2,
        vz=(pb >> 10) - 2,
        entered=((pa >> 1) & 1) != 0,
    )


def truncated(pa) -> torch.Tensor:
    """Rays that exhausted the tracer's budget (reported as misses)."""
    return ((pa >> TRUNCATED_BIT) & 1) != 0


def _safe_inv(d):
    # 1/d with the sign kept; |d| < 1e-30 gives a huge inverse so that
    # axis never wins the crossing selection
    tiny = torch.where(d >= 0, torch.full_like(d, 1e-30),
                       torch.full_like(d, -1e-30))
    return 1.0 / torch.where(d.abs() < 1e-30, tiny, d)


def _sign(d):
    return (d > 0).to(_I32) - (d < 0).to(_I32)


def trace_plain(scene, origin: V3, direction: V3, max_events: int,
                stats: dict | None = None, *, t_min: float = EPSILON_BLOCK,
                t_max: float = T_MAX):
    """Plain PyTorch version of the tracer kernel, with the arguments of
    `kernels.window_trace.window_trace`: every ray's first face crossing,
    at most `max_events` steps per ray.

    scene: anything with the SceneArrays fields `grid` ((gx, gy, gz) uint8
    block ids), `aux_grid` (its `make_aux_grid`, uint8) and `grid_origin`
    (3 ints, world coords of grid[0,0,0]).  Rays with a zero direction are
    inactive.  Hits count between t = t_min and t_max.  A ray
    still marching after `max_events` steps reports a miss with the
    truncated bit set.

    Step for step the JAX package's `dda_trace` with its aux grid: the
    slab entry and 1e-4 nudge, the pre-entry voxel of rays that start
    outside, and then per step either a fine crossing (crossing times
    recomputed from the voxel index, no drift; the x/y/z tie order; the
    enter-beats-exit face rule) or, from a voxel at distance >= 2, a skip
    to 1e-4 before the exit of the radius-(distance-1) cube (no face rule;
    the march ends when the landing leaves the grid or lands past the
    clip limit).  A skip is one step of the budget.  An aux grid whose
    distances are all 0 (`aux & 3`) gives the unskipped march.  Returns
    (pa, pb, t).

    stats: when a dict is given, its "fine" and "skips" are set to the
    steps of each kind the rays took (what a measurement of the kernel
    counts its work by), and its "per_ray" to each ray's steps, (N,)
    int32."""
    grid, grid_origin = scene.grid, scene.grid_origin
    gx, gy, gz = (int(s) for s in grid.shape)
    aux_flat = scene.aux_grid.reshape(-1).to(_I32)
    air = CLASS_TRANSPARENT | CLASS_TRANSLUCENT
    go = [float(g) for g in grid_origin]
    px, py, pz = origin.x - go[0], origin.y - go[1], origin.z - go[2]
    dx, dy, dz = direction.x, direction.y, direction.z
    valid = (dx != 0.0) | (dy != 0.0) | (dz != 0.0)
    ivx, ivy, ivz = _safe_inv(dx), _safe_inv(dy), _safe_inv(dz)
    mx, my, mz = dx.abs() > 1e-30, dy.abs() > 1e-30, dz.abs() > 1e-30
    inf = torch.full_like(px, INF_T)

    def slab(p, inv, dim, moving):
        lo = (0.0 - p) * inv
        hi = (dim - p) * inv
        near = torch.where(moving, torch.minimum(lo, hi), -inf)
        far = torch.where(moving, torch.maximum(lo, hi), inf)
        return near, far

    nx_, fx_ = slab(px, ivx, float(gx), mx)
    ny_, fy_ = slab(py, ivy, float(gy), my)
    nz_, fz_ = slab(pz, ivz, float(gz), mz)
    t_near = torch.maximum(nx_, torch.maximum(ny_, nz_))
    t_far = torch.minimum(fx_, torch.minimum(fy_, fz_))
    t_entry = torch.clamp_min(t_near, t_min)
    limit = torch.clamp_max(t_far, t_max)
    active = valid & (t_entry <= limit)
    sx, sy, sz = _sign(dx), _sign(dy), _sign(dz)

    # starting voxel, nudged inside along the ray; rays entering from
    # outside start in the pre-entry voxel so the loop evaluates the entry
    tn = t_entry + NUDGE
    vx = torch.floor(px + dx * tn).to(_I32)
    vy = torch.floor(py + dy * tn).to(_I32)
    vz = torch.floor(pz + dz * tn).to(_I32)
    outside = t_near > t_min
    ex = outside & (nx_ >= ny_) & (nx_ >= nz_)
    ey = outside & ~ex & (ny_ >= nz_)
    ez = outside & ~ex & ~ey
    zero = torch.zeros_like(vx)
    vx = vx - torch.where(ex, sx, zero)
    vy = vy - torch.where(ey, sy, zero)
    vz = vz - torch.where(ez, sz, zero)

    def lookup(vx, vy, vz):
        inside = ((vx >= 0) & (vx < gx) & (vy >= 0) & (vy < gy)
                  & (vz >= 0) & (vz < gz))
        idx = (vx.clamp(0, gx - 1).to(torch.int64) * (gy * gz)
               + vy.clamp(0, gy - 1).to(torch.int64) * gz
               + vz.clamp(0, gz - 1).to(torch.int64))
        return torch.where(inside, aux_flat[idx], air), inside, idx

    def cross_time(v, p, inv, s, moving):
        bound = v.to(_F32) + (s > 0).to(_F32)
        return torch.where(moving, (bound - p) * inv, inf)

    def cube_exit(v, p, inv, s, moving, r):
        # ray parameter where the ray leaves the radius-r cube around v
        # along one axis (dda_trace's skip, in its float order)
        bound = v.to(_F32) + torch.where(s > 0, r + 1.0, -r)
        return torch.where(moving, (bound - p) * inv, inf)

    cur, _, _ = lookup(vx, vy, vz)
    tx = cross_time(vx, px, ivx, sx, mx)
    ty = cross_time(vy, py, ivy, sy, my)
    tz = cross_time(vz, pz, ivz, sz, mz)

    out_hit = torch.zeros_like(active)
    out_t = inf.clone()
    out_face = zero.clone()
    out_vx, out_vy, out_vz = zero.clone(), zero.clone(), zero.clone()
    out_ent = torch.zeros_like(active)
    n_fine = n_skip = torch.zeros((), dtype=torch.int64, device=px.device)
    ray_steps = torch.zeros_like(vx)

    for step in range(max_events):
        if step % 8 == 0 and not bool(active.any()):
            break
        dist = cur >> 2
        do_skip = dist >= 2
        if stats is not None:
            n_fine = n_fine + (active & ~do_skip).sum()
            n_skip = n_skip + (active & do_skip).sum()
            ray_steps += active.to(_I32)
        use_x = (tx <= ty) & (tx <= tz)
        use_y = ~use_x & (ty <= tz)
        use_z = ~use_x & ~use_y
        t_cross = torch.where(use_x, tx, torch.where(use_y, ty, tz))
        f_vx = vx + torch.where(use_x, sx, zero)
        f_vy = vy + torch.where(use_y, sy, zero)
        f_vz = vz + torch.where(use_z, sz, zero)
        # empty-space skip: to just inside the exit of the radius-(dist-1)
        # cube around the current voxel
        r = (dist - 1).to(_F32)
        t_exit = torch.minimum(
            cube_exit(vx, px, ivx, sx, mx, r),
            torch.minimum(cube_exit(vy, py, ivy, sy, my, r),
                          cube_exit(vz, pz, ivz, sz, mz, r)))
        t_land = t_exit - SKIP_NUDGE
        nvx = torch.where(do_skip, torch.floor(px + dx * t_land).to(_I32), f_vx)
        nvy = torch.where(do_skip, torch.floor(py + dy * t_land).to(_I32), f_vy)
        nvz = torch.where(do_skip, torch.floor(pz + dz * t_land).to(_I32), f_vz)
        nxt, inside, _ = lookup(nvx, nvy, nvz)
        # the face rule holds only on fine crossings
        enter = ~do_skip & ((nxt & CLASS_TRANSPARENT) == 0) & (
            (cur & CLASS_TRANSLUCENT) != 0)
        leave = ~do_skip & ((cur & CLASS_TRANSPARENT) == 0) & (
            (nxt & CLASS_TRANSLUCENT) != 0)
        within = active & (t_cross <= limit) & (t_cross >= t_min)
        is_hit = within & (enter | leave)
        ax_step = torch.where(use_x, sx, torch.where(use_y, sy, sz))
        axis = torch.where(use_x, 0, torch.where(use_y, 1, 2)).to(_I32)
        nsign = torch.where(enter, -ax_step, ax_step)
        face = axis * 2 + (nsign > 0).to(_I32)
        out_hit = out_hit | is_hit
        out_t = torch.where(is_hit, t_cross, out_t)
        out_face = torch.where(is_hit, face, out_face)
        out_vx = torch.where(is_hit, torch.where(enter, nvx, vx), out_vx)
        out_vy = torch.where(is_hit, torch.where(enter, nvy, vy), out_vy)
        out_vz = torch.where(is_hit, torch.where(enter, nvz, vz), out_vz)
        out_ent = torch.where(is_hit, enter, out_ent)
        past = torch.where(do_skip, t_land > limit, t_cross > limit)
        active = active & ~is_hit & inside & ~past
        vx, vy, vz = nvx, nvy, nvz
        tx = cross_time(vx, px, ivx, sx, mx)
        ty = cross_time(vy, py, ivy, sy, my)
        tz = cross_time(vz, pz, ivz, sz, mz)
        cur = nxt

    _, _, idx = lookup(out_vx, out_vy, out_vz)
    flat = grid.reshape(-1)
    owner = torch.where(out_hit, flat[idx].to(_I32),
                        torch.full_like(out_vx, AIR_ID))
    pa, pb, t = pack_hits(VoxelHit(
        hit=out_hit, t=out_t, owner=owner, face=out_face,
        vx=out_vx, vy=out_vy, vz=out_vz, entered=out_ent,
    ))
    pa = pa | (active.to(_I32) << TRUNCATED_BIT)
    if stats is not None:
        stats["fine"], stats["skips"] = int(n_fine), int(n_skip)
        stats["per_ray"] = ray_steps
    return pa, pb, t


def dda_trace(grid, grid_origin, transparent, translucent, air_id: int,
              origin, direction, *, t_min: float = EPSILON_BLOCK,
              t_max: float = T_MAX, max_steps: int = 256, unroll: int = 8,
              aux_grid=None) -> VoxelHit:
    """The JAX package's `dda_trace` signature over `trace_plain`: the
    closest face hit of each ray of (N, 3) `origin` / `direction` (a zero
    direction is inactive) as a VoxelHit, on `origin`'s device.

    grid: (gx, gy, gz) block ids; transparent / translucent: (256,) bool
    block tables; aux_grid: the grid's `make_aux_grid` (the skipping
    march), or None for the class bits of the tables alone (no skip).  The
    march takes max_steps rounded up to a multiple of `unroll` steps, as
    the JAX loop runs `unroll` steps an iteration.  A miss (or a ray that
    runs out of steps) has owner `air_id`, t 3e38 and zero fields."""
    origin = torch.as_tensor(origin, dtype=_F32)
    dev = origin.device
    direction = torch.as_tensor(direction, dtype=_F32, device=dev)
    grid = torch.as_tensor(grid, device=dev)
    if aux_grid is None:
        cls = (torch.as_tensor(transparent, device=dev).to(torch.uint8)
               * CLASS_TRANSPARENT
               + torch.as_tensor(translucent, device=dev).to(torch.uint8)
               * CLASS_TRANSLUCENT)
        aux_grid = cls[grid.to(torch.int64)]
    scene = types.SimpleNamespace(
        grid=grid, aux_grid=torch.as_tensor(aux_grid, device=dev),
        grid_origin=[int(g) for g in np.asarray(grid_origin)])
    unroll = max(1, int(unroll))
    pa, pb, t = trace_plain(scene, V3.from_array(origin),
                            V3.from_array(direction),
                            -(-int(max_steps) // unroll) * unroll,
                            t_min=t_min, t_max=t_max)
    vox = unpack_hits(pa, pb, t)
    return vox._replace(owner=torch.where(
        vox.hit, vox.owner, torch.full_like(vox.owner, int(air_id))))


class TriHit(NamedTuple):
    """Closest entity-triangle hit, one entry per ray."""

    hit: torch.Tensor       # bool
    t: torch.Tensor         # f32 ray parameter (INF_T on a miss)
    tri: torch.Tensor       # int64 index of the winning triangle
    bary_u: torch.Tensor    # f32 barycentric of vertex 1
    bary_v: torch.Tensor    # f32 barycentric of vertex 2


# rays per pass of the sweep: bounds its (rays, triangles) float32
# temporaries to 64 MB each at 64 active triangles; per-ray results do not
# depend on it
TRI_RAY_CHUNK = 1 << 18


def triangle_sweep(tri_verts, tri_active, origin: V3, direction: V3, *,
                   t_min: float = EPSILON_BLOCK, t_max: float = T_MAX,
                   counts=None) -> TriHit:
    """Closest-hit Moller-Trumbore of every ray over the fixed triangle
    pool (tri_verts (T, 3, 3), tri_active (T,)).  Replaces the per-entity
    hardware BLAS of the reference (scene.rs:150-202): O(N*T), T small.
    counts: an int64 tensor whose first element the number of active
    triangles swept is added to, or None.  CUDA tensors launch the kernel
    (`kernels/tri_sweep.py`, one launch and no host sync), CPU tensors
    take `triangle_sweep_plain`."""
    if origin.x.device.type == "cuda":
        return TriHit(*tri_sweep(
            tri_verts.contiguous(), tri_active.contiguous(),
            *(V3(*(c.contiguous() for c in v)) for v in (origin, direction)),
            t_min, t_max, counts))
    return triangle_sweep_plain(tri_verts, tri_active, origin, direction,
                                t_min=t_min, t_max=t_max, counts=counts)


def triangle_sweep_plain(tri_verts, tri_active, origin: V3, direction: V3,
                         *, t_min: float = EPSILON_BLOCK,
                         t_max: float = T_MAX, counts=None) -> TriHit:
    """Plain PyTorch version of the sweep's kernel
    (`kernels/tri_sweep.py::tri_sweep`, `triangle_sweep`'s arguments), on
    any device.  Gathering the active triangles is a host sync
    (`sync.tri_pool`); the card's frame path launches the kernel, so the
    sync is the CPU's only."""
    # only the pool's active triangles are swept
    with spans.host_sync("sync.tri_pool"):
        pool = torch.nonzero(tri_active)[:, 0]
    n = origin.x.shape[0]
    if counts is not None and n:
        counts[0] += pool.shape[0]
    if pool.shape[0] == 0:
        zero = torch.zeros_like(origin.x)
        return TriHit(hit=torch.zeros(n, dtype=torch.bool, device=zero.device),
                      t=torch.full_like(zero, INF_T),
                      tri=torch.zeros(n, dtype=torch.int64, device=zero.device),
                      bary_u=zero, bary_v=zero)
    verts = tri_verts[pool]
    v0 = verts[:, 0]
    e1 = verts[:, 1] - v0
    e2 = verts[:, 2] - v0
    v0x, v0y, v0z = (v0[None, :, c] for c in range(3))
    e1x, e1y, e1z = (e1[None, :, c] for c in range(3))
    e2x, e2y, e2z = (e2[None, :, c] for c in range(3))
    parts = []
    for lo in range(0, max(n, 1), TRI_RAY_CHUNK):
        rows = slice(lo, lo + TRI_RAY_CHUNK)
        ox, oy, oz = (c[rows, None] for c in origin)
        dx, dy, dz = (c[rows, None] for c in direction)
        # pvec = d x e2
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = (px * e1x + py * e1y) + pz * e1z
        ok = det.abs() > 1e-12
        inv_det = torch.where(ok, 1.0 / det, torch.zeros_like(det))
        tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
        u = ((tx * px + ty * py) + tz * pz) * inv_det
        # qvec = tvec x e1
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        v = ((dx * qx + dy * qy) + dz * qz) * inv_det
        t = ((e2x * qx + e2y * qy) + e2z * qz) * inv_det
        ok = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= t_min)
              & (t <= t_max) & ((dx != 0.0) | (dy != 0.0) | (dz != 0.0)))
        t = torch.where(ok, t, torch.full_like(t, INF_T))
        best = torch.argmin(t, dim=1, keepdim=True)
        parts.append((best[:, 0], t.gather(1, best)[:, 0],
                      u.gather(1, best)[:, 0], v.gather(1, best)[:, 0]))
    best, best_t, best_u, best_v = (torch.cat(c) for c in zip(*parts))
    hit = best_t < INF_T
    # a ray that hits nothing names triangle 0, as an argmin over the
    # whole pool would
    return TriHit(hit=hit, t=best_t,
                  tri=torch.where(hit, pool[best], torch.zeros_like(best)),
                  bary_u=best_u, bary_v=best_v)

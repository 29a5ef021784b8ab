"""Wavefront stages as plain functions on SoA ray tensors.

Counterparts of `wavefront_tpu.render.wavefront`: raygen, the light-BVH
walks of sparse light sets (stochastic descent, a kernel on the card,
`kernels/light_walk.py`; reverse walk), the dense light-BVH math
(node/prim importances, descent probabilities, the light pick), the NEE
pdf sweep on both paths (the sparse one a kernel on the card,
`kernels/nee_sweep.py`), the sampling helpers and postprocess.
Radiometric semantics follow the reference shaders
(raygen.rs, raytrace.rs, nee_pdf.rs, postprocess.rs); the dense light path
replaces the stochastic descent and the reverse walk with the same
distribution drawn from one uniform (see the JAX package's module notes).

The fused shade kernel (`kernels/shade.py`) computes the same functions
per ray; its plain version reuses the importance functions below.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from wavefront_tpu_torch.core import rng, vec3
from wavefront_tpu_torch.core.config import EPSILON_BLOCK, EPSILON_NEE, T_MAX
from wavefront_tpu_torch.core.vec3 import V3
from wavefront_tpu_torch.kernels.light_walk import light_walk
from wavefront_tpu_torch.kernels.nee_sweep import nee_sweep
from wavefront_tpu_torch.utils import spans

_F32 = torch.float32
_PI = math.pi


class LightArrays(NamedTuple):
    """Tensor mirror of lights.LightSet (padded to its buckets).  uint32
    fields are int64 tensors holding the unsigned value (the sentinel
    0xFFFFFFFF included)."""

    p0: torch.Tensor          # (P, 3) f32
    e1: torch.Tensor          # (P, 3)
    e2: torch.Tensor          # (P, 3)
    is_tri: torch.Tensor      # (P,) bool
    area: torch.Tensor        # (P,)
    power: torch.Tensor       # (P,)
    leaf_node: torch.Tensor   # (P,) int64
    num_prims: int
    node_left: torch.Tensor   # (M,) int64
    node_right: torch.Tensor  # (M,) int64
    node_min: torch.Tensor    # (M, 3)
    node_max: torch.Tensor    # (M, 3)
    node_power: torch.Tensor  # (M,)
    node_parent: torch.Tensor  # (M,) int64
    ancestors: torch.Tensor   # (M, P) f32 path indicator, or (1, 1)
    leaf_prim: torch.Tensor   # (M,) int64 prim per leaf, -1 elsewhere
    prim_min: torch.Tensor    # (P, 3)
    prim_max: torch.Tensor    # (P, 3)

    @property
    def dense(self) -> bool:
        """Whether the light set rides the dense path."""
        return self.ancestors.shape[0] > 1


class BvhSample(NamedTuple):
    success: torch.Tensor      # (N,) bool
    prim: torch.Tensor         # (N,) int64
    probability: torch.Tensor  # (N,)
    importance: torch.Tensor   # (N,)


# ---------------------------------------------------------------------------
# raygen (reference raygen.rs:88-116)
# ---------------------------------------------------------------------------


def raygen_soa(eye, front, right, up, width: int, height: int,
               jitter: float = 0.0, seed=None, device="cuda", pixels=None):
    """Pinhole rays: (origin V3, direction V3, ray ids), id = y*width + x
    (int32), for every pixel or, with `pixels=(lo, hi)`, for the ids
    lo <= id < hi only, in id order.  A ray's arithmetic and draws depend
    on its id alone, so a range's rays equal those of the whole image."""
    lo, hi = (0, width * height) if pixels is None else pixels
    pid = torch.arange(int(lo), int(hi), device=device, dtype=torch.int32)
    y = pid // width
    x = pid - y * width
    # uv = 2*screen/size - 1 (reference raygen.rs:84-86,103)
    u = 2.0 * x.to(_F32) / float(width) - 1.0
    v = 2.0 * y.to(_F32) / float(height) - 1.0
    if jitter != 0.0 and seed is not None:
        s = rng.combine(seed, pid)
        ju = rng.finalizef(rng.combine(s, 0)) - 0.5
        jv = rng.finalizef(rng.combine(s, 1)) - 0.5
        u = u + jitter * (2.0 / width) * ju
        v = v + jitter * (2.0 / height) * jv
    aspect = float(torch.tensor(width / height, dtype=_F32))
    f = [float(c) for c in front]
    r = [float(c) for c in right]
    w = [float(c) for c in up]
    # association matches the reference: ((u*right)*aspect + v*up) + front
    d = V3(
        u * r[0] * aspect + v * w[0] + f[0],
        u * r[1] * aspect + v * w[1] + f[1],
        u * r[2] * aspect + v * w[2] + f[2],
    )
    d = d / vec3.norm(d)
    n = pid.shape[0]
    e = [float(c) for c in eye]
    origin = V3(
        torch.full((n,), e[0], dtype=_F32, device=device),
        torch.full((n,), e[1], dtype=_F32, device=device),
        torch.full((n,), e[2], dtype=_F32, device=device),
    )
    return origin, d, pid


def raygen(eye, front, right, up, width: int, height: int,
           jitter: float = 0.0, seed=None, device="cuda"):
    """(N, 3)-tensor form of `raygen_soa`: (origin, direction, ray ids)
    for every pixel."""
    o, d, ray_id = raygen_soa(eye, front, right, up, width, height,
                              jitter=jitter, seed=seed, device=device)
    return o.stack(), d.stack(), ray_id


# ---------------------------------------------------------------------------
# light BVH walks (reference raytrace.rs:186-293, nee_pdf.rs:119-228)
# ---------------------------------------------------------------------------

_SENTINEL = 0xFFFFFFFF


class _Nodes(NamedTuple):
    """The node SoA ready for per-ray row gathers."""

    left: torch.Tensor     # (M,) int64, -1 at a leaf
    right: torch.Tensor    # (M,) int64: right child, or the prim of a leaf
    parent: torch.Tensor   # (M,) int64, -1 at the root
    box: torch.Tensor      # (M, 7) f32: min xyz, max xyz, power


def _nodes(lights: LightArrays) -> _Nodes:
    def idx(a):
        return torch.where(a == _SENTINEL, torch.full_like(a, -1), a)

    return _Nodes(
        idx(lights.node_left), idx(lights.node_right),
        idx(lights.node_parent),
        torch.cat([lights.node_min, lights.node_max,
                   lights.node_power[:, None]], dim=1))


def _row_importance(point: V3, normal: V3, box, eps):
    """nodeImportance of one gathered (N, 7) box row per ray."""
    return aabb_importance(
        box[:, 0], box[:, 1], box[:, 2], box[:, 3], box[:, 4], box[:, 5],
        box[:, 6], point.x, point.y, point.z, normal.x, normal.y, normal.z,
        eps, False)


def _child_importances(nodes: _Nodes, node, point: V3, normal: V3, eps):
    """(left child, right child, importance of each) of `node`'s children;
    a leaf's children read as node 0 and are masked by the callers."""
    li = nodes.left[node].clamp_min(0)
    ri = nodes.right[node].clamp_min(0)
    return (li, ri, _row_importance(point, normal, nodes.box[li], eps),
            _row_importance(point, normal, nodes.box[ri], eps))


def traverse_light_bvh(lights: LightArrays, point: V3, normal: V3, seed,
                       active, max_depth: int) -> BvhSample:
    """Stochastic top-down descent, importance-proportional at every split
    (reference raytrace.rs:230-293), over the one-level global BVH; one
    fresh murmur3 uniform per level, at most `max_depth` levels.  seed:
    int64 tensor of u32 values.  CUDA tensors launch the kernel
    (`kernels/light_walk.py`, one launch and no host sync), CPU tensors
    take `light_walk_plain`."""
    if point.x.device.type == "cuda":
        return BvhSample(*light_walk(
            lights, *(V3(*(c.contiguous() for c in v))
                      for v in (point, normal)),
            seed.contiguous(), active.contiguous(), max_depth))
    return light_walk_plain(lights, point, normal, seed, active, max_depth)


def light_walk_plain(lights: LightArrays, point: V3, normal: V3, seed,
                     active, max_depth: int) -> BvhSample:
    """Plain PyTorch version of the walk's kernel
    (`kernels/light_walk.py::light_walk`, same arguments), on any device:
    every ray steps one level at a time.  Each level's test for a running
    walk is a host sync (`sync.light_walk`); each level stepped counts in
    `spans.light_walk_levels`.  The card's frame path launches the kernel,
    so both are counted on the CPU only."""
    n = point.x.shape[0]
    nodes = _nodes(lights)
    # dummy-root check (reference raytrace.rs:235-243)
    root_leaf = nodes.left[0] < 0
    have_lights = ~(root_leaf & (nodes.right[0] < 0))
    root_imp = _row_importance(point, normal, nodes.box[:1].expand(n, 7),
                               EPSILON_BLOCK)
    node = torch.zeros(n, dtype=torch.int64, device=point.x.device)
    prob = torch.ones_like(point.x)
    imp = torch.where(root_leaf, root_imp, torch.zeros_like(root_imp))
    running = active & have_lights
    s = rng.as_u32(seed)
    for _ in range(max_depth):
        with spans.host_sync("sync.light_walk"):
            if not bool(running.any()):
                break
        spans.count_walk_level()
        stepping = running & (nodes.left[node] >= 0)
        li, ri, imp_l, imp_r = _child_importances(
            nodes, node, point, normal, EPSILON_BLOCK)
        total = imp_l + imp_r
        # the reference divides blindly (raytrace.rs:279-280); its 0/0 NaN
        # sends the walk right with importance 0, which the caller rejects
        norm_l = torch.where(total > 0, imp_l / total.clamp_min(1e-30),
                             torch.zeros_like(total))
        go_left = rng.finalizef(s) < norm_l
        node = torch.where(stepping, torch.where(go_left, li, ri), node)
        prob = torch.where(
            stepping, prob * torch.where(go_left, norm_l, 1.0 - norm_l), prob)
        imp = torch.where(stepping, torch.where(go_left, imp_l, imp_r), imp)
        s = rng.combine(s, 0)
        running = stepping
    success = active & have_lights & (nodes.left[node] < 0)
    prim = nodes.right[node].clamp_min(0)
    return BvhSample(success=success,
                     prim=torch.where(success, prim, torch.zeros_like(prim)),
                     probability=prob, importance=imp)


def reverse_walk_prob(lights: LightArrays, point: V3, normal: V3, leaf_node,
                      active, max_depth: int):
    """Probability that the forward descent would have picked `leaf_node`,
    rebuilt bottom-up through the parent pointers (reference
    nee_pdf.rs:154-228), with the NEE epsilon (nee_pdf.rs:15).  Each
    level's test for a running walk is a host sync
    (`sync.reverse_walk`)."""
    nodes = _nodes(lights)
    node = torch.where(active, leaf_node.to(torch.int64),
                       torch.zeros_like(leaf_node, dtype=torch.int64))
    prob = torch.ones_like(point.x)
    running = active
    for _ in range(max_depth):
        with spans.host_sync("sync.reverse_walk"):
            if not bool(running.any()):
                break
        parent = nodes.parent[node]
        stepping = running & (parent >= 0)
        pi = parent.clamp_min(0)
        li, _, imp_l, imp_r = _child_importances(
            nodes, pi, point, normal, EPSILON_NEE)
        total = imp_l + imp_r
        branch = torch.where(
            total > 0,
            torch.where(node == li, imp_l, imp_r) / total.clamp_min(1e-30),
            torch.zeros_like(total))
        prob = torch.where(stepping, prob * branch, prob)
        node = torch.where(stepping, pi, node)
        running = stepping
    return torch.where(active, prob, torch.zeros_like(prob))


# ---------------------------------------------------------------------------
# dense light-BVH math (reference raytrace.rs:193-293 as one distribution)
# ---------------------------------------------------------------------------


def aabb_importance(mnx, mny, mnz, mxx, mxy, mxz, power, x, y, z,
                    nx, ny, nz, eps, guard: bool):
    """nodeImportance (reference raytrace.rs:193-220): power / distance^2
    times the visible fraction of the 8 box corners.  All arguments
    broadcast (the dense functions pass (1, M) bounds against an (N, 1)
    point and normal; the shade passes one box per ray); guard protects
    the 0/0 of padded prim columns."""
    visible = None
    for cx in (mnx, mxx):
        dx = (cx - x) * nx
        for cy in (mny, mxy):
            dy = (cy - y) * ny
            sxy = dx + dy
            for cz in (mnz, mxz):
                dz = (cz - z) * nz
                v = (sxy + dz >= eps).to(_F32)
                visible = v if visible is None else visible + v
    ex, ey, ez = mxx - mnx, mxy - mny, mxz - mnz
    diag_sq = (ex * ex + ey * ey) + ez * ez
    cx_ = 0.5 * (mnx + mxx) - x
    cy_ = 0.5 * (mny + mxy) - y
    cz_ = 0.5 * (mnz + mxz) - z
    dist_sq = torch.maximum(diag_sq, (cx_ * cx_ + cy_ * cy_) + cz_ * cz_)
    if guard:
        dist_sq = torch.clamp_min(dist_sq, 1e-30)
    return power / dist_sq * (visible * 0.125)


def _box_importance(mn, mx, power, point: V3, normal: V3, eps, guard):
    # (N, B) importance of B boxes ((B, 3) bounds) from N points
    return aabb_importance(
        mn[None, :, 0], mn[None, :, 1], mn[None, :, 2],
        mx[None, :, 0], mx[None, :, 1], mx[None, :, 2], power[None, :],
        point.x[:, None], point.y[:, None], point.z[:, None],
        normal.x[:, None], normal.y[:, None], normal.z[:, None],
        eps, guard,
    )


def dense_node_importance(lights: LightArrays, point: V3, normal: V3,
                          eps=EPSILON_BLOCK):
    """(N, M) importance of every node from every shading point."""
    return _box_importance(lights.node_min, lights.node_max,
                           lights.node_power, point, normal, eps, False)


def dense_prim_importance(lights: LightArrays, point: V3, normal: V3,
                          eps=EPSILON_BLOCK):
    """(N, P) leaf importance of every prim (its exact leaf AABB)."""
    return _box_importance(lights.prim_min, lights.prim_max, lights.power,
                           point, normal, eps, True)


def normalized_node_importance(imp: torch.Tensor) -> torch.Tensor:
    """(N, M) branch probability imp(a) / (imp(a) + imp(sibling(a))).

    Siblings are (1,2), (3,4), ... by builder construction; the root is 1;
    a padded last row without a partner is 0."""
    m = imp.shape[1]
    j = torch.arange(m, device=imp.device)
    sib = torch.where(j % 2 == 1, (j + 1) % m, j - 1)
    tot = imp + imp[:, sib]
    nimp = torch.where(tot > 0, imp / torch.clamp_min(tot, 1e-30),
                       torch.zeros_like(imp))
    nimp[:, 0] = 1.0
    m2 = ((m - 1) // 2) * 2
    if m2 + 1 < m:
        nimp[:, m2 + 1:] = 0.0
    return nimp


def dense_prim_probs(lights: LightArrays, point: V3, normal: V3,
                     eps=EPSILON_BLOCK):
    """(N, P) descent probability of every prim: exp of the sum over its
    non-root path nodes of log(max(nimp, 1e-35)); padded prims are 0."""
    nimp = normalized_node_importance(
        dense_node_importance(lights, point, normal, eps))
    log_nimp = torch.log(torch.clamp_min(nimp, 1e-35))
    logp = log_nimp @ lights.ancestors
    p = lights.ancestors.shape[1]
    valid = torch.arange(p, device=logp.device)[None, :] < lights.num_prims
    return torch.where(valid, torch.exp(logp), torch.zeros_like(logp))


def dense_sample_light(lights: LightArrays, point: V3, normal: V3, seed,
                       active):
    """Importance-proportional prim pick from the dense probabilities
    (replaces the stochastic descent).  Returns (BvhSample, probs)."""
    probs = dense_prim_probs(lights, point, normal)
    imp = dense_prim_importance(lights, point, normal, EPSILON_BLOCK)
    total = probs.sum(dim=1)
    u = rng.finalizef(seed) * total
    cum = torch.cumsum(probs, dim=1)
    # first prim column whose cumulative reaches u
    reached = cum >= u[:, None]
    before = torch.cat(
        [torch.zeros_like(reached[:, :1]), reached[:, :-1]], dim=1)
    pick = reached & ~before & (probs > 0)
    cols = torch.arange(probs.shape[1], device=probs.device, dtype=_F32)
    pickf = pick.to(_F32)
    prim_f = (pickf * cols[None, :]).sum(1)
    prob = (pickf * probs).sum(1)
    importance = (pickf * imp).sum(1)
    ok = active & (total > 0) & pick.any(dim=1)
    return (
        BvhSample(
            success=ok,
            prim=torch.where(ok, prim_f.to(torch.int64),
                             torch.zeros_like(prim_f, dtype=torch.int64)),
            probability=prob,
            importance=importance,
        ),
        probs,
    )


# ---------------------------------------------------------------------------
# NEE pdf sweep (reference nee_pdf.rs:281-337)
# ---------------------------------------------------------------------------

# rays per pass of the sparse sweep's plain version: bounds its (rays,
# prim_tile) float32 temporaries to 128 MB each; per-ray results do not
# depend on it
RAY_CHUNK = 1 << 19


def _prim_tile_hits(lights: LightArrays, point: V3, direction: V3, active,
                    pid):
    """Crossing test of every ray against one tile of light prims.

    pid: (T,) prim indices (may run past num_prims; masked).  Returns
    (hit (N, T) bool, t (N, T) ray parameter)."""
    cap = lights.p0.shape[0]
    pc = pid.clamp(0, cap - 1)
    p0, e1, e2 = lights.p0[pc], lights.e1[pc], lights.e2[pc]
    nv = torch.linalg.cross(e1, e2)
    d11 = (e1[:, 0] * e1[:, 0] + e1[:, 1] * e1[:, 1]) + e1[:, 2] * e1[:, 2]
    d22 = (e2[:, 0] * e2[:, 0] + e2[:, 1] * e2[:, 1]) + e2[:, 2] * e2[:, 2]
    d12 = (e1[:, 0] * e2[:, 0] + e1[:, 1] * e2[:, 1]) + e1[:, 2] * e2[:, 2]
    det = d11 * d22 - d12 * d12
    dx, dy, dz = (direction.x[:, None], direction.y[:, None],
                  direction.z[:, None])
    px, py, pz = point.x[:, None], point.y[:, None], point.z[:, None]
    denom = (dx * nv[None, :, 0] + dy * nv[None, :, 1]) + dz * nv[None, :, 2]
    safe = denom.abs() > 1e-12
    t = ((p0[None, :, 0] - px) * nv[None, :, 0]
         + (p0[None, :, 1] - py) * nv[None, :, 1]) \
        + (p0[None, :, 2] - pz) * nv[None, :, 2]
    t = t / torch.where(safe, denom, torch.ones_like(denom))
    hx = px + dx * t - p0[None, :, 0]
    hy = py + dy * t - p0[None, :, 1]
    hz = pz + dz * t - p0[None, :, 2]
    r1 = (hx * e1[None, :, 0] + hy * e1[None, :, 1]) + hz * e1[None, :, 2]
    r2 = (hx * e2[None, :, 0] + hy * e2[None, :, 1]) + hz * e2[None, :, 2]
    inv_det = torch.where(det.abs() > 1e-20, 1.0 / det, torch.zeros_like(det))
    u = (r1 * d22[None, :] - r2 * d12[None, :]) * inv_det[None, :]
    v = (r2 * d11[None, :] - r1 * d12[None, :]) * inv_det[None, :]
    in_quad = (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1)
    in_tri = (u >= 0) & (v >= 0) & (u + v <= 1)
    inside = torch.where(lights.is_tri[pc][None, :], in_tri, in_quad)
    hit = (active[:, None] & (pid < lights.num_prims)[None, :] & safe
           & inside & (t >= EPSILON_NEE) & (t <= T_MAX))
    return hit, t


def nee_pdf_sweep(lights: LightArrays, point: V3, normal: V3,
                  direction: V3, mis_weight, dense_probs,
                  max_depth: int = 32, max_hits: int = 8,
                  prim_tile: int = 64, with_overflow: bool = False,
                  counts=None):
    """Sum over the light prims crossed by the outgoing ray of
    walk_prob * t^2 / (cos_theta * area) (nee_pdf.rs:264-334).

    Dense path (dense_probs given): walk probabilities are columns of the
    dense (N, P) matrix and EVERY crossing counts, as in the reference;
    `prim_tile` prims at a time against all rays.

    Sparse path (dense_probs None): each ray that can contribute (MIS
    weight above 0, a live direction) sums its first `max_hits` crossings,
    in prim order, each with its reverse BVH walk.  A ray that crosses
    more under-counts its pdf.  CUDA tensors launch the kernel
    (`kernels/nee_sweep.py`), CPU tensors take `nee_sweep_plain`.  Both
    add the crossings and the rays that crossed more than `max_hits` to
    `counts`, a (2,) int64 tensor on the rays' device, with no host sync
    for them: the renderer reads it with its frame's audit, and then the
    sweep returns the pdf alone.  Without `counts` the sweep reads its own
    in one host sync (`sync.nee_overflow`), counts the crossings in
    `spans.nee_crossings`, and with_overflow also returns the overflowing
    rays (always 0 on the dense path), which the renderer reports as
    aux["nee_overflow"]."""
    n = point.x.shape[0]
    dev = point.x.device
    cap = lights.p0.shape[0]
    prim_tile = min(prim_tile, cap)
    bases = range(0, lights.num_prims, prim_tile)

    if dense_probs is not None:
        active = (mis_weight > 0) & vec3.any_nonzero(direction)
        cos_theta = vec3.dot(normal, direction)
        pdf = torch.zeros(n, dtype=_F32, device=dev)
        for base in bases:
            pid = torch.arange(base, base + prim_tile, device=dev)
            pc = pid.clamp(0, cap - 1)
            hit, t = _prim_tile_hits(lights, point, direction, active, pid)
            # the denominator at 1 where no prim is crossed, so that no
            # masked lane divides 0 by 0
            den = cos_theta[:, None] * lights.area[pc][None, :]
            contrib = dense_probs[:, pc] * t * t / torch.where(
                hit, den, torch.ones_like(den))
            pdf = pdf + torch.where(hit, contrib,
                                    torch.zeros_like(contrib)).sum(1)
        if with_overflow:
            return pdf, 0
        return pdf

    own = counts is None
    if own:
        counts = torch.zeros(2, dtype=torch.int64, device=dev)
    elif with_overflow:
        raise ValueError("nee_pdf_sweep: with_overflow reads the sweep's "
                         "own counts; given `counts`, the caller reads them")
    if dev.type == "cuda":
        pdf = nee_sweep(lights, *(V3(*(c.contiguous() for c in v))
                                  for v in (point, normal, direction)),
                        mis_weight.contiguous(), max_depth, max_hits, counts)
    else:
        pdf = nee_sweep_plain(lights, point, normal, direction, mis_weight,
                              max_depth, max_hits, counts, prim_tile)
    if not own:
        return pdf
    with spans.host_sync("sync.nee_overflow"):
        crossings, overflow = counts.tolist()
    spans.count_crossings(crossings)
    return (pdf, overflow) if with_overflow else pdf


def nee_sweep_plain(lights: LightArrays, point: V3, normal: V3,
                    direction: V3, mis_weight, max_depth: int,
                    max_hits: int, counts, prim_tile: int = 64):
    """Plain PyTorch version of the sparse sweep's kernel
    (`kernels/nee_sweep.py::nee_sweep`, same arguments; per-ray results do
    not depend on `prim_tile`), on any device: the rays that can
    contribute are gathered; each one's first
    `max_hits` crossings, `prim_tile` prims at a time in prim order, go
    into slots, and one reverse BVH walk runs over the used (slot, ray)
    pairs.  The crossings and the rays with more than `max_hits` of them
    are added to `counts`.

    Its gathers of a data-dependent size (`torch.nonzero`, a boolean
    mask's rows) and its reverse walk's levels are host syncs
    (`sync.nee_sweep`, `sync.nee_slots`, `sync.reverse_walk`)."""
    def masked(x, mask):
        with spans.host_sync("sync.nee_slots"):
            return x[mask]

    active = (mis_weight > 0) & vec3.any_nonzero(direction)
    cos_theta = vec3.dot(normal, direction)
    n = point.x.shape[0]
    dev = point.x.device
    prim_tile = min(prim_tile, lights.p0.shape[0])
    with spans.host_sync("sync.nee_sweep"):
        act = torch.nonzero(active)[:, 0]
    na = act.shape[0]
    pt, nm, dr = (v.map(lambda c: c[act]) for v in (point, normal, direction))
    cos_theta = cos_theta[act]
    every = torch.ones(na, dtype=torch.bool, device=dev)
    slot_leaf = torch.zeros((max_hits, na), dtype=torch.int64, device=dev)
    slot_area = torch.zeros((max_hits, na), dtype=_F32, device=dev)
    slot_t = torch.zeros((max_hits, na), dtype=_F32, device=dev)
    slot_used = torch.zeros((max_hits, na), dtype=torch.bool, device=dev)
    count = torch.zeros(na, dtype=torch.int64, device=dev)
    crossings = 0
    for lo in range(0, na, RAY_CHUNK):
        rows = slice(lo, lo + RAY_CHUNK)
        cpt = pt.map(lambda c: c[rows])
        cdr = dr.map(lambda c: c[rows])
        for base in range(0, lights.num_prims, prim_tile):
            pid = torch.arange(base, base + prim_tile, device=dev)
            hit, t = _prim_tile_hits(lights, cpt, cdr, every[rows], pid)
            # the crossings, by ray and then by prim; the slot of each is
            # the number of crossings before it on its ray
            with spans.host_sync("sync.nee_sweep"):
                ray, col = torch.nonzero(hit, as_tuple=True)
            crossings += ray.shape[0]
            rank = torch.arange(ray.shape[0], device=dev) \
                - torch.searchsorted(ray, ray)
            tt = t[ray, col]
            ray = ray + lo
            k = count[ray] + rank
            # unclamped: a final count above max_hits is the overflow
            count.index_add_(0, ray, torch.ones_like(ray))
            keep = k < max_hits
            k, ray, pc = masked(k, keep), masked(ray, keep), \
                pid[masked(col, keep)]
            slot_leaf[k, ray] = lights.leaf_node[pc]
            slot_area[k, ray] = lights.area[pc]
            slot_t[k, ray] = masked(tt, keep)
            # a Python scalar stored on the device: a blocking copy
            with spans.host_sync("sync.nee_slots"):
                slot_used[k, ray] = True

    with spans.host_sync("sync.nee_sweep"):
        k, ray = torch.nonzero(slot_used, as_tuple=True)
    walk = torch.zeros((max_hits, na), dtype=_F32, device=dev)
    walk[k, ray] = reverse_walk_prob(
        lights, pt.map(lambda c: c[ray]), nm.map(lambda c: c[ray]),
        slot_leaf[k, ray], torch.ones_like(ray, dtype=torch.bool), max_depth)
    den = cos_theta[None, :] * slot_area
    point_pick = slot_t * slot_t / torch.where(slot_used, den,
                                               torch.ones_like(den))
    pdf = torch.zeros(n, dtype=_F32, device=dev)
    pdf[act] = torch.where(slot_used, walk * point_pick,
                           torch.zeros_like(walk)).sum(0)
    counts[0] += crossings
    counts[1] += (count > max_hits).sum()
    return pdf


# ---------------------------------------------------------------------------
# radiance accumulation (reference outgoing_radiance.rs:58-93)
# ---------------------------------------------------------------------------


def accumulate_radiance(emissivity, reflectivity, mis_weight, bsdf_pdf,
                        nee_pdf, valid):
    """Backward recurrence L_b = E_b + R_b * L_{b+1} * (p/q) * valid_b with
    the one-sample-MIS reweighting q = nee*w + (1-w)*bsdf
    (outgoing_radiance.rs:77-87).  The renderer folds the throughput
    forward instead (`shading.throughput_factor`); this is the per-bounce
    form the oracle and the golden tests write.

    Inputs (B, N, ...): emissivity and reflectivity (B, N, 3), the rest
    (B, N); returns the bounce-0 radiance (N, 3)."""
    radiance = torch.zeros_like(emissivity[0])
    for b in range(emissivity.shape[0] - 1, -1, -1):
        q = nee_pdf[b] * mis_weight[b] + (1.0 - mis_weight[b]) * bsdf_pdf[b]
        # q == 0 happens: finalizef rounds to exactly 1.0 about once in
        # 2^25 draws, which makes a grazing cosine sample with bsdf_pdf
        # exactly 0.  The reference's shader computes 0/0 there (a NaN
        # pixel, outgoing_radiance.rs:84); such a sample adds nothing
        # beyond its own emission, as in the JAX package and the oracle.
        w = torch.where(q > 0.0, bsdf_pdf[b] / torch.clamp_min(q, 1e-35),
                        torch.zeros_like(q))
        radiance = emissivity[b] + reflectivity[b] * radiance * (
            w * valid[b].to(w.dtype))[:, None]
    return radiance


# ---------------------------------------------------------------------------
# postprocess (reference postprocess.rs:33-76)
# ---------------------------------------------------------------------------


def postprocess(radiance, width: int, height: int, scale: int,
                debug=None, debug_view: int = 0):
    """Box-downsample the supersampled (N, 3) radiance (the `debug` buffer
    when debug_view != 0) by `scale`; returns (height, width, 3) float32,
    no tone mapping (postprocess.rs:66)."""
    img = (debug if debug_view != 0 else radiance).reshape(
        height * scale, width * scale, 3)
    if scale > 1:
        img = img.reshape(height, scale, width, scale, 3).mean(dim=(1, 3))
    return img


# ---------------------------------------------------------------------------
# sampling helpers (reference raytrace.rs:295-357)
# ---------------------------------------------------------------------------


def cosine_hemisphere(u1, u2, normal: V3, tangent: V3, bitangent: V3) -> V3:
    """Cosine-weighted hemisphere sample in the (tangent, normal,
    bitangent) frame (reference raytrace.rs:308-313, 354-357)."""
    theta = float(torch.tensor(2.0 * _PI, dtype=_F32)) * u1
    r = torch.sqrt(torch.clamp_min(1.0 - u2, 0.0))
    hx = r * torch.cos(theta)
    hy = torch.sqrt(u2)
    hz = r * torch.sin(theta)
    d = V3(
        (hx * tangent.x + hy * normal.x) + hz * bitangent.x,
        (hx * tangent.y + hy * normal.y) + hz * bitangent.y,
        (hx * tangent.z + hy * normal.z) + hz * bitangent.z,
    )
    return d / vec3.norm(d)


def reflect(d: V3, n: V3) -> V3:
    """GLSL reflect (reference raytrace.rs:594-597)."""
    k = 2.0 * vec3.dot(d, n)
    return V3(d.x - k * n.x, d.y - k * n.y, d.z - k * n.z)

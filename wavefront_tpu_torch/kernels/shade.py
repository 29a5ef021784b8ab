"""The fused shade: the CUDA kernel `csrc/shade.cu`, its plain PyTorch
version `shade_plain`, and the light tables both read.

Replaces the TPU kernel `wavefront_tpu/kernels/shade.py::_kernel` (called
by `shade_pass()`): per ray, the renderer's shade (texels, emission, the
murmur3 3-way scatter, the MIS-0.3 light/hemisphere sample, the sky), the
dense light-BVH pick, the dense NEE pdf sweep and the throughput/radiance
fold, in one pass that reads each ray's state once and writes it once.

Bound on the card: 112 bytes per ray cross device memory (16 input and 12
output words; 100 in the bf16 color build, whose throughput is 2 bytes a
component in and out; with the entity stream `tri_attrs` 4 more for the
flag word, and 44 more on each lane an entity wins); the atlas stays in
L2 and the light tables in shared memory, staged once per resident block.
A ray that takes NEE also evaluates the light BVH once (a table of every
live node's log branch probability, then each prim's path sum) and sweeps
the prims' planes; that work grows with the light set (see the source
note in the .cu file and PERF.md).

`shade_plain` is the renderer's shade (`render/shading.py`) with the dense
light pick and pdf sweep in the kernel's order (each node's log branch
probability once, each prim's sum along its path leaf first, sums in prim
order), so on the card the two differ only by the rounding of
cos/sin/log/exp.

`color_bf16` (settings.shade_bf16) is the reference's bf16 color build:
the throughput carry in and out is bfloat16, and reflectivity, emission,
the sky and the throughput factor are rounded to bfloat16 where the
reference rounds them (`shading.shade_rays`); the MIS weight is taken in
float32 and rounded once, and radiance accumulates in float32.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from wavefront_tpu_torch.core import rng, vec3
from wavefront_tpu_torch.core.config import EPSILON_BLOCK, EPSILON_NEE, T_MAX
from wavefront_tpu_torch.core.vec3 import V3
from wavefront_tpu_torch.kernels import _build
from wavefront_tpu_torch.kernels.texel import texel_plain
from wavefront_tpu_torch.render.intersect import unpack_hits
from wavefront_tpu_torch.render.shading import (
    CHANNELS,
    EntityHit,
    color_dtype,
    shade_rays,
    throughput_factor,
)
from wavefront_tpu_torch.render.wavefront import (
    BvhSample,
    aabb_importance,
    normalized_node_importance,
)

_F32 = torch.float32
# light-table caps of the kernel (shared memory: 16 KB of nodes and
# 32 KB of prims at the caps); its per-ray node table holds 2 P nodes,
# which every light set's M fits (M = bucket(2p - 1) <= 2 bucket(p))
MAX_NODES = 512
MAX_PRIMS = 256


class ShadeTables(NamedTuple):
    """Per-scene tables of the shade (prep_shade_tables)."""

    atlas: torch.Tensor    # (T, S, S, 12) f32 packed atlas
    nodes: torch.Tensor    # (M, 8) f32: min xyz, max xyz, power, 0
    parent: torch.Tensor   # (M,) int32 parent node, -1 at the root
    prims: torch.Tensor    # (P, 32) f32, columns:
    #   0-2 p0 | 3-5 e1 | 6-8 e2 | 9 is_tri | 10 area | 11 power
    #   12-14 prim_min | 15-17 prim_max | 18-20 nvec |
    #   21 d11 | 22 d22 | 23 d12 | 24 inv_det |
    #   25 p0.nvec | 26 p0.e1 | 27 p0.e2 | 28-31 zero
    leaf: torch.Tensor     # (P,) int32 leaf node of each prim
    paths: tuple           # per real prim: its non-root ancestors, leaf first
    live: int              # rows of the kernel's node table: nodes 1..live-1,
    #                        in sibling pairs (odd j, j+1), hold every path
    dense: bool

    @property
    def m_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def p_prims(self) -> int:
        return self.prims.shape[0]


def _dot3(a, b):
    return (a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1]) + a[:, 2] * b[:, 2]


def prep_shade_tables(atlas_packed, lights) -> ShadeTables:
    """Build the shade tables from the scene's atlas and LightArrays (once
    per scene; reads the parent pointers on the host)."""
    dev = atlas_packed.device
    dense = lights.dense
    if dense:
        nodes = torch.cat([
            lights.node_min, lights.node_max, lights.node_power[:, None],
            torch.zeros_like(lights.node_power[:, None]),
        ], dim=1)
        p0, e1, e2 = lights.p0, lights.e1, lights.e2
        nvec = torch.linalg.cross(e1, e2)
        d11, d22, d12 = _dot3(e1, e1), _dot3(e2, e2), _dot3(e1, e2)
        det = d11 * d22 - d12 * d12
        inv_det = torch.where(det.abs() > 1e-20, 1.0 / det,
                              torch.zeros_like(det))
        cols = [
            p0, e1, e2, lights.is_tri.to(_F32)[:, None],
            lights.area[:, None], lights.power[:, None],
            lights.prim_min, lights.prim_max, nvec,
            d11[:, None], d22[:, None], d12[:, None], inv_det[:, None],
            _dot3(p0, nvec)[:, None], _dot3(p0, e1)[:, None],
            _dot3(p0, e2)[:, None],
        ]
        prims = torch.cat(cols, dim=1)
        prims = torch.cat(
            [prims, torch.zeros((prims.shape[0], 4), dtype=_F32, device=dev)],
            dim=1)
        parent_u = lights.node_parent.cpu().numpy()
        parent = np.where(parent_u == 0xFFFFFFFF, -1, parent_u).astype(np.int32)
        leaf = lights.leaf_node.cpu().numpy().astype(np.int32)
        paths = []
        for q in range(lights.num_prims):
            path, a = [], int(leaf[q])
            while a > 0:
                path.append(a)
                a = int(parent[a])
            paths.append(tuple(path))
    else:
        nodes = torch.zeros((8, 8), dtype=_F32, device=dev)
        prims = torch.zeros((8, 32), dtype=_F32, device=dev)
        parent = np.full(8, -1, np.int32)
        leaf = np.zeros(8, np.int32)
        paths = ()
    # the highest node on a path, and the sibling pair it belongs to
    top = max((a for p in paths for a in p), default=0)
    return ShadeTables(
        atlas=atlas_packed.contiguous(),
        nodes=nodes.contiguous(),
        parent=torch.as_tensor(parent, device=dev),
        prims=prims.contiguous(),
        leaf=torch.as_tensor(leaf, device=dev),
        paths=tuple(paths),
        live=min(nodes.shape[0], (top + 1) | 1),
        dense=dense,
    )


def _pick_kernel_order(tables: ShadeTables, num_prims: int):
    """The dense light pick in the kernel's order: each prim's probability
    by a walk up its parents, the running sum in prim order.  Returns the
    `pick` of `shading.shade_rays`; what it gives second is the list of
    per-prim (N,) probabilities."""
    def pick(point: V3, normal: V3, seed, active):
        zero = torch.zeros_like(point.x)
        nd = tables.nodes
        node_imp = aabb_importance(
            nd[None, :, 0], nd[None, :, 1], nd[None, :, 2],
            nd[None, :, 3], nd[None, :, 4], nd[None, :, 5], nd[None, :, 6],
            point.x[:, None], point.y[:, None], point.z[:, None],
            normal.x[:, None], normal.y[:, None], normal.z[:, None],
            EPSILON_BLOCK, False)
        logn = torch.log(torch.clamp_min(
            normalized_node_importance(node_imp), 1e-35))
        probs = []
        total = zero
        for q in range(tables.p_prims):
            p = zero
            if q < num_prims:
                logp = zero
                for a in tables.paths[q]:
                    logp = logp + logn[:, a]
                p = torch.exp(logp)
            probs.append(p)
            total = total + p
        uu = rng.finalizef(seed) * total
        cum, cnt = zero, torch.zeros_like(seed, dtype=torch.int64)
        for p in probs:
            cum = cum + p
            cnt = cnt + (cum < uu).to(torch.int64)
        idx = cnt.clamp_max(tables.p_prims - 1)
        prob = torch.stack(probs, dim=1).gather(1, idx[:, None])[:, 0]
        prow = tables.prims[idx]
        imp = aabb_importance(
            prow[:, 12], prow[:, 13], prow[:, 14], prow[:, 15], prow[:, 16],
            prow[:, 17], prow[:, 11], *point, *normal, EPSILON_BLOCK, True)
        ok = active & (total > 0) & (prob > 0)
        return BvhSample(ok, idx, prob, imp), probs

    return pick


def _pdf_kernel_order(tables: ShadeTables, num_prims: int, probs, point: V3,
                      normal: V3, direction: V3, mis):
    """The dense NEE pdf sweep in the kernel's order: prim by prim, from
    the precomputed plane and edge products of the prim table."""
    nox, noy, noz = point
    ndx, ndy, ndz = direction
    pdf = torch.zeros_like(mis)
    one = torch.ones_like(mis)
    act = (mis > 0) & vec3.any_nonzero(direction)
    cos_r = vec3.dot(normal, direction)
    for q in range(min(num_prims, tables.p_prims)):
        c = [float(x) for x in tables.prims[q].cpu()]
        nvd = (c[18] * ndx + c[19] * ndy) + c[20] * ndz
        nvo = (c[18] * nox + c[19] * noy) + c[20] * noz
        safe = nvd.abs() > 1e-12
        tt = (c[25] - nvo) / torch.where(safe, nvd, one)
        r1 = (((c[3] * nox + c[4] * noy) + c[5] * noz)
              + tt * ((c[3] * ndx + c[4] * ndy) + c[5] * ndz)) - c[26]
        r2 = (((c[6] * nox + c[7] * noy) + c[8] * noz)
              + tt * ((c[6] * ndx + c[7] * ndy) + c[8] * ndz)) - c[27]
        uq = (r1 * c[22] - r2 * c[23]) * c[24]
        vq = (r2 * c[21] - r1 * c[23]) * c[24]
        if c[9] > 0.5:
            inside = (uq >= 0) & (vq >= 0) & (uq + vq <= 1)
        else:
            inside = (uq >= 0) & (uq <= 1) & (vq >= 0) & (vq <= 1)
        hitp = act & safe & inside & (tt >= EPSILON_NEE) & (tt <= T_MAX)
        contrib = probs[q] * tt * tt / (cos_r * c[10])
        pdf = pdf + torch.where(hitp, contrib, torch.zeros_like(pdf))
    return pdf


class _PrimGeometry(NamedTuple):
    """The light prims' geometry as `shading.shade_rays` reads it, from
    the columns of the prim table."""

    p0: torch.Tensor
    e1: torch.Tensor
    e2: torch.Tensor
    is_tri: torch.Tensor


def shade_plain(tables: ShadeTables, grid_origin, origin: V3, direction: V3,
                pa, pb, t, tp: V3, rad: V3, rid, inv_seed: int, bounce: int,
                num_prims: int, *, nee_type: int, tri_attrs=None,
                color_bf16: bool = False):
    """Plain PyTorch version of the shade kernel (same arguments as
    shade_pass); returns (origin', direction', tp', rad') as V3s.

    The shade itself is the renderer's (`shading.shade_rays` on
    `texel_plain`); only the dense light pick and pdf sweep are written
    out here, in the kernel's order.  tp is taken in the color dtype, as
    the reference casts it."""
    cdt = color_dtype(color_bf16)
    tp = tp.map(lambda c: c.to(cdt))
    vox = unpack_hits(pa, pb, t)
    entity = None
    if tri_attrs is not None:
        # entity hits (bit 16 of the flag word) take the winning triangle's
        # frame, uv and texture over the voxel face's; t is already merged
        a = tri_attrs
        use = ((a[11] >> 16) & 1) != 0
        entity = EntityHit(use, V3(*a[0:3]), V3(*a[3:6]), V3(*a[6:9]),
                           a[9], a[10], a[11] & 0xFFFF)
        vox = vox._replace(hit=vox.hit | use)
    pr = tables.prims
    geometry = _PrimGeometry(pr[:, 0:3], pr[:, 3:6], pr[:, 6:9],
                             pr[:, 9] > 0.5)

    def fetch(tex, u, v):
        return texel_plain(tables.atlas, tex, u, v, channels=CHANNELS)

    (new_o, new_d, normal, emis, refl, mis, bsdf_pdf, probs) = shade_rays(
        grid_origin, geometry, nee_type, bounce, origin,
        direction, rng.combine(inv_seed, rid), vox, entity, fetch,
        _pick_kernel_order(tables, num_prims), color_bf16=color_bf16)
    if nee_type == 0:
        nee_pdf = torch.zeros_like(mis)
    else:
        nee_pdf = _pdf_kernel_order(tables, num_prims, probs, new_o, normal,
                                    new_d, mis)
    factor = throughput_factor(new_d, refl, mis, bsdf_pdf, nee_pdf)
    # tp * emis is a product in the color dtype; float32 radiance widens it
    return new_o, new_d, tp * factor, rad + tp * emis


_LAUNCH = _build.Launcher("shade", "shade_launch", "pppipiippippiiifffuiii",
                         "shade_pass")


def shade_pass(tables: ShadeTables, grid_origin, origin: V3, direction: V3,
               pa, pb, t, tp: V3, rad: V3, rid, inv_seed: int, bounce: int,
               num_prims: int, *, nee_type: int, tri_attrs=None,
               color_bf16: bool = False):
    """One fused shade step.  Returns (origin', direction', tp', rad').

    origin/direction/rad: V3 of (N,) float32; tp: V3 of (N,) tensors of
    the color dtype, float32 or, with color_bf16, bfloat16 (so is tp');
    pa/pb: packed int32 hit words, t: float32 hit parameter
    (window_trace); rid: (N,) int32 pixel ids; inv_seed: frame * bounces
    + bounce.

    tri_attrs: when the scene holds dynamic entities, the winning entity
    triangle's attributes per ray as 12 (N,) tensors: normal xyz, tangent
    xyz, bitangent xyz, u, v (float32) and the int32 flag word texture |
    use_tri << 16; `t` must already be the merged closest-hit parameter
    (`render.renderer.entity_attrs` makes both).  Lanes with bit 16 set
    shade as entity hits (reference raytrace.rs:541-566).

    color_bf16: the bf16 color pipeline (settings.shade_bf16; see the
    module note).

    CPU tensors take `shade_plain`; CUDA tensors launch the kernel or
    raise."""
    if nee_type not in (0, 1, 2):
        raise ValueError(f"nee_type {nee_type} is not one of 0, 1, 2")
    if nee_type != 0:
        if not tables.dense:
            raise ValueError("NEE on the fused shade needs a dense light set")
        if (tables.m_nodes > min(MAX_NODES, 2 * tables.p_prims)
                or tables.p_prims > MAX_PRIMS):
            raise ValueError(
                f"light set of {tables.m_nodes} nodes / {tables.p_prims} "
                f"prims exceeds the shade caps {MAX_NODES}/{MAX_PRIMS}")
    inv_seed = int(inv_seed) & 0xFFFFFFFF
    ins = (*origin, *direction, pa, pb, t, *tp, *rad, rid)
    if tri_attrs is not None and len(tri_attrs) != 12:
        raise ValueError("shade_pass: tri_attrs must hold 12 tensors")
    if origin.x.device.type == "cpu":
        return shade_plain(tables, grid_origin, origin, direction, pa, pb, t,
                           tp, rad, rid, inv_seed, int(bounce),
                           int(num_prims), nee_type=nee_type,
                           tri_attrs=tri_attrs, color_bf16=color_bf16)
    dev = origin.x.device
    n = origin.x.shape[0]
    cdt = color_dtype(color_bf16)
    want = [_F32] * 6 + [torch.int32, torch.int32, _F32] + [cdt] * 3 + \
        [_F32] * 3 + [torch.int32]
    tri = tuple(tri_attrs) if tri_attrs is not None else ()
    if tri:
        want = want + [torch.float32] * 11 + [torch.int32]
    for x, dt in zip(ins + tri, want):
        if (x.device != dev or x.dtype != dt or x.dim() != 1
                or x.shape[0] != n or not x.is_contiguous()):
            raise ValueError("shade_pass: inputs must be contiguous (N,) "
                             "tensors of the documented dtypes on one device")
    m, p = tables.m_nodes, tables.p_prims
    a = tables.atlas
    for x, dt, shape in (
            (a, _F32, (a.shape[0], a.shape[1], a.shape[1], 12)),
            (tables.nodes, _F32, (m, 8)), (tables.parent, torch.int32, (m,)),
            (tables.prims, _F32, (p, 32)), (tables.leaf, torch.int32, (p,))):
        if (x.device != dev or x.dtype != dt or tuple(x.shape) != shape
                or not x.is_contiguous()):
            raise ValueError("shade_pass: tables must be contiguous tensors "
                             "of prep_shade_tables' layout on the rays' "
                             "device")
    outs = [torch.empty(n, dtype=cdt if 6 <= k < 9 else _F32, device=dev)
            for k in range(12)]
    in_ptrs = (ctypes.c_void_p * 16)(*(x.data_ptr() for x in ins))
    out_ptrs = (ctypes.c_void_p * 12)(*(x.data_ptr() for x in outs))
    tri_ptrs = (ctypes.c_void_p * 12)(*(x.data_ptr() for x in tri)) \
        if tri else None
    g = [float(v) for v in grid_origin]
    _LAUNCH(dev.index, in_ptrs, out_ptrs, tri_ptrs, n, tables.atlas.data_ptr(),
            tables.atlas.shape[1], tables.atlas.shape[0],
            tables.nodes.data_ptr(), tables.parent.data_ptr(), tables.m_nodes,
            tables.prims.data_ptr(), tables.leaf.data_ptr(), tables.p_prims,
            int(num_prims), tables.live, g[0], g[1], g[2], inv_seed,
            int(bounce), nee_type, int(bool(color_bf16)))
    shade_pass.launches += 1
    return (V3(*outs[0:3]), V3(*outs[3:6]), V3(*outs[6:9]), V3(*outs[9:12]))


shade_pass.launches = 0

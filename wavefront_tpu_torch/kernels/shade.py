"""The fused shade: the CUDA kernel `csrc/shade.cu`, its plain PyTorch
version `shade_plain`, and the light tables both read.

Replaces the TPU kernel `wavefront_tpu/kernels/shade.py::_kernel` (called
by `shade_pass()`): per ray, the renderer's shade (texels, emission, the
murmur3 3-way scatter, the MIS-0.3 light/hemisphere sample, the sky), the
dense light-BVH pick, the dense NEE pdf sweep and the throughput/radiance
fold, in one pass that reads each ray's state once and writes it once.

Bound on the card: 112 bytes per ray cross device memory (16 input and 12
output words); the atlas stays in L2 and the light tables in shared
memory.  At the headline's 8 light prims that byte bound is the floor;
the per-ray light walk and pdf sweep grow with the prim count (see the
source note in the .cu file and PERF.md).

`shade_plain` repeats the kernel's arithmetic in the kernel's order (prim
probabilities by a walk up the parents, sums in prim order), so on the card
the two differ only by the rounding of cos/sin/log/exp.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from wavefront_tpu_torch.core import rng, vec3
from wavefront_tpu_torch.core.config import (
    EMISSION_SCALE,
    EPSILON_BLOCK,
    EPSILON_NEE,
    MISS_DISTANCE,
    NEE_MIS_WEIGHT,
    SKY_COS_CUTOFF,
    SKY_EMISSION,
    T_MAX,
)
from wavefront_tpu_torch.core.vec3 import V3
from wavefront_tpu_torch.kernels import _build
from wavefront_tpu_torch.render.wavefront import (
    aabb_importance,
    cosine_hemisphere,
    normalized_node_importance,
    reflect,
)

_F32 = torch.float32
# the 8 packed-atlas channels the shade reads: reflectivity rgb, alpha,
# emissivity rgb, metallicity
CHANNELS = (0, 1, 2, 3, 4, 5, 6, 8)
# light-table caps of the kernel (shared memory: 16 KB of nodes and
# 32 KB of prims at the caps)
MAX_NODES = 512
MAX_PRIMS = 256
_INV_PI = float(np.float32(1.0 / math.pi))
_EPS15 = float(np.float32(EPSILON_BLOCK * 1.5))


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
    return ShadeTables(
        atlas=atlas_packed.contiguous(),
        nodes=nodes.contiguous(),
        parent=torch.as_tensor(parent, device=dev),
        prims=prims.contiguous(),
        leaf=torch.as_tensor(leaf, device=dev),
        paths=tuple(paths),
        dense=dense,
    )


def shade_plain(tables: ShadeTables, grid_origin, origin: V3, direction: V3,
                pa, pb, t, tp: V3, rad: V3, rid, inv_seed: int, bounce: int,
                num_prims: int, *, nee_type: int):
    """Plain PyTorch version of the shade kernel (same arguments as
    shade_pass); returns (origin', direction', tp', rad') as V3s."""
    f32 = dict(dtype=_F32, device=origin.x.device)
    ox, oy, oz = origin
    dx, dy, dz = direction
    zero = torch.zeros_like(ox)
    one = torch.ones_like(ox)
    alive = vec3.any_nonzero(direction)

    # ---- hit record ----
    hit = (pa & 1) != 0
    face = (pa >> 2) & 7
    owner = (pa >> 14) & 255
    vx = (pb & 1023) - 2
    vy = ((pa >> 5) & 511) - 2
    vz = (pb >> 10) - 2
    hpx, hpy, hpz = ox + dx * t, oy + dy * t, oz + dz * t

    # ---- face frame and uv ----
    axis = face >> 1
    signf = ((face & 1) * 2 - 1).to(_F32)
    n_x = torch.where(axis == 0, signf, zero)
    n_y = torch.where(axis == 1, signf, zero)
    n_z = torch.where(axis == 2, signf, zero)
    tg_x = torch.where(axis == 2, one, zero)
    tg_y = torch.where(axis == 0, one, zero)
    tg_z = torch.where(axis == 1, one, zero)
    bt_x = n_y * tg_z - n_z * tg_y
    bt_y = n_z * tg_x - n_x * tg_z
    bt_z = n_x * tg_y - n_y * tg_x
    g = [float(v) for v in grid_origin]
    lx = hpx - (vx.to(_F32) + g[0])
    ly = hpy - (vy.to(_F32) + g[1])
    lz = hpz - (vz.to(_F32) + g[2])
    u = torch.where(face == 0, 1.0 - lz, torch.where(
        face == 1, lz, torch.where(face == 2, lx, torch.where(
            face == 3, 1.0 - lx, torch.where(face == 4, lx, 1.0 - lx)))))
    v = torch.where((face == 2) | (face == 3), lz, 1.0 - ly)

    # ---- texels ----
    n_tex, size = tables.atlas.shape[0], tables.atlas.shape[1]
    tex = (owner * 6 + face).clamp(0, n_tex - 1).to(torch.int64)
    ti = (u * float(size)).to(torch.int32).clamp(0, size - 1).to(torch.int64)
    tj = (v * float(size)).to(torch.int32).clamp(0, size - 1).to(torch.int64)
    texel = tables.atlas[tex, tj, ti][:, list(CHANNELS)]
    ch = [torch.where(hit, texel[:, c], zero) for c in range(len(CHANNELS))]
    cos_in = -((dx * n_x + dy * n_y) + dz * n_z)
    emx = EMISSION_SCALE * ch[4] * cos_in
    emy = EMISSION_SCALE * ch[5] * cos_in
    emz = EMISSION_SCALE * ch[6] * cos_in
    alpha, metal = ch[3], ch[7]

    # ---- scatter decision ----
    seed = rng.combine(inv_seed, rid)
    scatter_rand = rng.finalizef(rng.combine(seed, 0))
    is_mirror = scatter_rand < metal
    is_trans = ~is_mirror & (scatter_rand < metal + (1.0 - alpha))
    is_lamb = hit & ~is_mirror & ~is_trans
    lox, loy, loz = hpx + _EPS15 * n_x, hpy + _EPS15 * n_y, hpz + _EPS15 * n_z
    if nee_type == 1:
        do_nee = is_lamb
    elif nee_type == 2:
        do_nee = is_lamb & (bounce == 0)
    else:
        do_nee = torch.zeros_like(is_lamb)

    # ---- dense light pick ----
    p_prims = tables.p_prims
    probs = []
    prow = torch.zeros((ox.shape[0], 32), **f32)
    imp, ok = zero, torch.zeros_like(is_lamb)
    if nee_type != 0:
        nd = tables.nodes
        node_imp = aabb_importance(
            nd[None, :, 0], nd[None, :, 1], nd[None, :, 2],
            nd[None, :, 3], nd[None, :, 4], nd[None, :, 5], nd[None, :, 6],
            lox[:, None], loy[:, None], loz[:, None],
            n_x[:, None], n_y[:, None], n_z[:, None], EPSILON_BLOCK, False)
        logn = torch.log(torch.clamp_min(
            normalized_node_importance(node_imp), 1e-35))
        total = zero
        for q in range(p_prims):
            p = zero
            if q < num_prims:
                logp = zero
                for a in tables.paths[q]:
                    logp = logp + logn[:, a]
                p = torch.exp(logp)
            probs.append(p)
            total = total + p
        uu = rng.finalizef(rng.combine(seed, 2)) * total
        cum, cnt = zero, torch.zeros_like(rid, dtype=torch.int64)
        for p in probs:
            cum = cum + p
            cnt = cnt + (cum < uu).to(torch.int64)
        idx = cnt.clamp_max(p_prims - 1)
        prob = torch.stack(probs, dim=1).gather(1, idx[:, None])[:, 0]
        prow = tables.prims[idx]
        imp = aabb_importance(
            prow[:, 12], prow[:, 13], prow[:, 14], prow[:, 15], prow[:, 16],
            prow[:, 17], prow[:, 11], lox, loy, loz, n_x, n_y, n_z,
            EPSILON_BLOCK, True)
        ok = do_nee & (total > 0) & (prob > 0)
    mis = torch.where(ok & (imp > 0.0), NEE_MIS_WEIGHT, 0.0).to(_F32)
    pick_light = rng.finalizef(rng.combine(seed, 3)) < mis
    u4 = rng.finalizef(rng.combine(seed, 4))
    u5 = rng.finalizef(rng.combine(seed, 5))

    fold = (prow[:, 9] > 0.5) & (u4 + u5 > 1.0)
    lu = torch.where(fold, 1.0 - u4, u4)
    lv = torch.where(fold, 1.0 - u5, u5)
    tlx = ((prow[:, 0] + lu * prow[:, 3]) + lv * prow[:, 6]) - lox
    tly = ((prow[:, 1] + lu * prow[:, 4]) + lv * prow[:, 7]) - loy
    tlz = ((prow[:, 2] + lu * prow[:, 5]) + lv * prow[:, 8]) - loz
    tl_n = torch.clamp_min(torch.sqrt((tlx * tlx + tly * tly) + tlz * tlz),
                           1e-20)
    ldx, ldy, ldz = tlx / tl_n, tly / tl_n, tlz / tl_n

    normal = V3(n_x, n_y, n_z)
    hemi = cosine_hemisphere(u4, u5, normal, V3(tg_x, tg_y, tg_z),
                             V3(bt_x, bt_y, bt_z))
    lamdx = torch.where(pick_light, ldx, hemi.x)
    lamdy = torch.where(pick_light, ldy, hemi.y)
    lamdz = torch.where(pick_light, ldz, hemi.z)
    lam_bsdf = ((lamdx * n_x + lamdy * n_y) + lamdz * n_z) * _INV_PI

    # ---- merge branches ----
    nox = torch.where(is_lamb, lox, hpx)
    noy = torch.where(is_lamb, loy, hpy)
    noz = torch.where(is_lamb, loz, hpz)
    mirror = reflect(direction, normal)
    ndx = torch.where(is_mirror, mirror.x, torch.where(is_trans, dx, lamdx))
    ndy = torch.where(is_mirror, mirror.y, torch.where(is_trans, dy, lamdy))
    ndz = torch.where(is_mirror, mirror.z, torch.where(is_trans, dz, lamdz))
    orx = torch.where(is_mirror, ch[0], torch.where(is_trans, one, ch[0] * _INV_PI))
    ory = torch.where(is_mirror, ch[1], torch.where(is_trans, one, ch[1] * _INV_PI))
    orz = torch.where(is_mirror, ch[2], torch.where(is_trans, one, ch[2] * _INV_PI))
    bsdf = torch.where(is_lamb, lam_bsdf, one)
    mis_o = torch.where(is_lamb, mis, zero)

    # ---- miss: directional sky ----
    miss = ~hit
    sky = torch.where(dy > SKY_COS_CUTOFF, SKY_EMISSION, 0.0).to(_F32)
    nox = torch.where(miss, ox + dx * MISS_DISTANCE, nox)
    noy = torch.where(miss, oy + dy * MISS_DISTANCE, noy)
    noz = torch.where(miss, oz + dz * MISS_DISTANCE, noz)
    ndx, ndy, ndz = (torch.where(miss, zero, c) for c in (ndx, ndy, ndz))
    nmx, nmy, nmz = (torch.where(miss, zero, c) for c in (n_x, n_y, n_z))
    ex, ey, ez = (torch.where(miss, sky, c) for c in (emx, emy, emz))
    orx, ory, orz = (torch.where(miss, zero, c) for c in (orx, ory, orz))
    mis_o = torch.where(miss, zero, mis_o)
    bsdf = torch.where(miss, one, bsdf)

    # ---- dense NEE pdf sweep ----
    pdf = zero
    if nee_type != 0:
        act = (mis_o > 0) & ((ndx != 0.0) | (ndy != 0.0) | (ndz != 0.0))
        cos_r = (nmx * ndx + nmy * ndy) + nmz * ndz
        pr = tables.prims
        for q in range(min(num_prims, p_prims)):
            c = [float(x) for x in pr[q].cpu()]
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
            pdf = pdf + torch.where(hitp, contrib, zero)

    # ---- throughput/radiance fold ----
    valid = ((ndx != 0.0) | (ndy != 0.0) | (ndz != 0.0)).to(_F32)
    qq = pdf * mis_o + (1.0 - mis_o) * bsdf
    w = torch.where(qq > 0.0, bsdf / torch.clamp_min(qq, 1e-35), zero)
    wv = w * valid
    tpx, tpy, tpz = tp
    rax, ray_, raz = rad

    def out(live, dead):
        return torch.where(alive, live, dead)

    new_o = V3(out(nox, ox), out(noy, oy), out(noz, oz))
    new_d = V3(out(ndx, zero), out(ndy, zero), out(ndz, zero))
    new_tp = V3(out(tpx * (orx * wv), tpx * 0.0), out(tpy * (ory * wv), tpy * 0.0),
                out(tpz * (orz * wv), tpz * 0.0))
    new_rad = V3(out(rax + tpx * ex, rax + tpx * 0.0),
                 out(ray_ + tpy * ey, ray_ + tpy * 0.0),
                 out(raz + tpz * ez, raz + tpz * 0.0))
    return new_o, new_d, new_tp, new_rad


def _lib():
    lib = _build.load("shade")
    if not getattr(lib, "_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.shade_launch.argtypes = [
            p, p, i, p, i, i, p, p, i, p, p, i, i, f, f, f,
            ctypes.c_uint, i, i, p]
        lib.shade_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def shade_pass(tables: ShadeTables, grid_origin, origin: V3, direction: V3,
               pa, pb, t, tp: V3, rad: V3, rid, inv_seed: int, bounce: int,
               num_prims: int, *, nee_type: int, tri_attrs=None,
               color_bf16: bool = False):
    """One fused shade step.  Returns (origin', direction', tp', rad').

    origin/direction/tp/rad: V3 of (N,) float32; pa/pb: packed int32 hit
    words, t: float32 hit parameter (window_trace); rid: (N,) int32 pixel
    ids; inv_seed: frame * bounces + bounce.  CPU tensors take
    `shade_plain`; CUDA tensors launch the kernel or raise."""
    if tri_attrs is not None:
        raise NotImplementedError(
            "dynamic entities on the fused shade are not ported yet")
    if color_bf16:
        raise NotImplementedError("the bf16 color pipeline is not ported yet")
    if nee_type not in (0, 1, 2):
        raise ValueError(f"nee_type {nee_type} is not one of 0, 1, 2")
    if nee_type != 0:
        if not tables.dense:
            raise ValueError("NEE on the fused shade needs a dense light set")
        if tables.m_nodes > MAX_NODES or tables.p_prims > MAX_PRIMS:
            raise ValueError(
                f"light set of {tables.m_nodes} nodes / {tables.p_prims} "
                f"prims exceeds the shade caps {MAX_NODES}/{MAX_PRIMS}")
    inv_seed = int(inv_seed) & 0xFFFFFFFF
    ins = (*origin, *direction, pa, pb, t, *tp, *rad, rid)
    if origin.x.device.type == "cpu":
        return shade_plain(tables, grid_origin, origin, direction, pa, pb, t,
                           tp, rad, rid, inv_seed, int(bounce),
                           int(num_prims), nee_type=nee_type)
    dev = origin.x.device
    n = origin.x.shape[0]
    want = [torch.float32] * 6 + [torch.int32, torch.int32] + \
        [torch.float32] * 7 + [torch.int32]
    for x, dt in zip(ins, want):
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
    outs = [torch.empty(n, dtype=_F32, device=dev) for _ in range(12)]
    in_ptrs = (ctypes.c_void_p * 16)(*(x.data_ptr() for x in ins))
    out_ptrs = (ctypes.c_void_p * 12)(*(x.data_ptr() for x in outs))
    g = [float(v) for v in grid_origin]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().shade_launch(
        in_ptrs, out_ptrs, n, tables.atlas.data_ptr(),
        tables.atlas.shape[1], tables.atlas.shape[0],
        tables.nodes.data_ptr(), tables.parent.data_ptr(), tables.m_nodes,
        tables.prims.data_ptr(), tables.leaf.data_ptr(), tables.p_prims,
        int(num_prims), g[0], g[1], g[2], inv_seed, int(bounce),
        nee_type, stream)
    _build.check(err, "shade_pass")
    shade_pass.launches += 1
    return (V3(*outs[0:3]), V3(*outs[3:6]), V3(*outs[6:9]), V3(*outs[9:12]))


shade_pass.launches = 0

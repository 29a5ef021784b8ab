"""Scalar NumPy oracle renderer.

An independent, deliberately slow per-pixel implementation of the exact
radiometric model (same murmur3 draw order, scatter rules, NEE weights, sky,
uv conventions as renderer.py / the reference's raytrace.rs), used as ground
truth for golden-image RMSE tests on tiny configurations — the test pyramid
role the reference's commented-out inline harnesses play (SURVEY.md
section 4).  Shares only *data* (BlockRegistry, LightSet) with the device
path; all math here is re-derived scalar code.

A copy of `wavefront_tpu.render.oracle` on the port's config, light
set and block registry.
"""

from __future__ import annotations

import math

import numpy as np

from wavefront_tpu_torch.core.config import (
    EMISSION_SCALE,
    EPSILON_BLOCK,
    EPSILON_NEE,
    MISS_DISTANCE,
    NEE_MIS_WEIGHT,
    RenderSettings,
    SKY_COS_CUTOFF,
    SKY_EMISSION,
    T_MAX,
)
from wavefront_tpu_torch.render.lights import SENTINEL, LightSet
from wavefront_tpu_torch.world.blocks import BlockRegistry, TEX_SIZE

_M = 0xFFFFFFFF
_PI = math.pi

_FACE_NORMAL = np.array(
    [[-1, 0, 0], [1, 0, 0], [0, -1, 0], [0, 1, 0], [0, 0, -1], [0, 0, 1]],
    np.float64,
)
_FACE_TANGENT = np.array(
    [[0, 1, 0], [0, 1, 0], [0, 0, 1], [0, 0, 1], [1, 0, 0], [1, 0, 0]],
    np.float64,
)


def _combine(h, k):
    k = (k * 0x1B873593) & _M
    h ^= k
    h = ((h << 13) | (h >> 19)) & _M
    h = (h * 5 + 0xE6546B64) & _M
    return h


def _finalize(h):
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M
    h ^= h >> 16
    return h


def _finalizef(h):
    m = (_finalize(h) & 0x007FFFFF) | 0x3F800000
    return float(np.uint32(m).view(np.float32)) - 1.0


class OracleRenderer:
    def __init__(
        self,
        settings: RenderSettings,
        registry: BlockRegistry,
        grid: np.ndarray,
        grid_origin,
        lights: LightSet,
        tri_verts=None,
        tri_uv=None,
        tri_tex=None,
    ):
        self.s = settings
        self.reg = registry
        self.grid = np.asarray(grid)
        self.origin = np.asarray(grid_origin, np.float64)
        self.lights = lights
        self.tri_verts = tri_verts if tri_verts is not None else np.zeros((0, 3, 3))
        self.tri_uv = tri_uv if tri_uv is not None else np.zeros((0, 3, 2))
        self.tri_tex = tri_tex if tri_tex is not None else np.zeros(0, np.int64)
        nb = registry.num_blocks
        self.transparent = np.zeros(256, bool)
        self.translucent = np.zeros(256, bool)
        self.transparent[: nb + 1] = registry.transparent
        self.translucent[: nb + 1] = registry.translucent
        self.transparent[nb + 1:] = True
        self.translucent[nb + 1:] = True

    # ---- intersection ----

    def _block(self, v):
        g = self.grid
        if np.any(v < 0) or np.any(v >= np.array(g.shape)):
            return 255
        return int(g[tuple(v)])

    def _dda(self, o, d):
        """Scalar DDA; returns None or (t, owner, face, voxel)."""
        g = self.grid
        dims = np.array(g.shape, np.float64)
        p0 = o - self.origin
        with np.errstate(divide="ignore"):
            inv = np.where(np.abs(d) > 1e-30, 1.0 / d, np.inf)
        t_lo = (0.0 - p0) * inv
        t_hi = (dims - p0) * inv
        t_near_ax = np.where(np.isfinite(inv), np.minimum(t_lo, t_hi), -np.inf)
        t_far_ax = np.where(np.isfinite(inv), np.maximum(t_lo, t_hi), np.inf)
        t_near = t_near_ax.max()
        t_far = t_far_ax.min()
        t_entry = max(t_near, EPSILON_BLOCK)
        if t_entry > min(t_far, T_MAX):
            return None
        step = np.sign(d).astype(np.int64)
        vox = np.floor(p0 + d * (t_entry + 1e-4)).astype(np.int64)
        if t_near > EPSILON_BLOCK:
            ax = int(np.argmax(t_near_ax))
            vox[ax] -= step[ax]
        cur = self._block(vox)
        limit = min(t_far, T_MAX)
        for _ in range(8 * int(dims.max())):
            tmax = np.where(
                np.isfinite(inv),
                ((vox + (step > 0)) - p0) * inv,
                np.inf,
            )
            ax = int(np.argmin(tmax))
            t = tmax[ax]
            if t > limit:
                return None
            nvox = vox.copy()
            nvox[ax] += step[ax]
            nxt = self._block(nvox)
            enter = (not self.transparent[nxt]) and self.translucent[cur]
            exit_ = (not self.transparent[cur]) and self.translucent[nxt]
            if t >= EPSILON_BLOCK and (enter or exit_):
                if enter:
                    face = ax * 2 + (0 if step[ax] > 0 else 1)
                    return t, nxt, face, nvox
                face = ax * 2 + (1 if step[ax] > 0 else 0)
                return t, cur, face, vox
            inside = np.all(nvox >= 0) and np.all(nvox < dims)
            if not inside:
                return None
            vox, cur = nvox, nxt
        return None

    def _tri_hit(self, o, d):
        best = None
        for i in range(len(self.tri_verts)):
            v0, v1, v2 = self.tri_verts[i]
            e1, e2 = v1 - v0, v2 - v0
            p = np.cross(d, e2)
            det = e1 @ p
            if abs(det) < 1e-12:
                continue
            tv = o - v0
            u = (tv @ p) / det
            q = np.cross(tv, e1)
            v = (d @ q) / det
            t = (e2 @ q) / det
            if u < 0 or v < 0 or u + v > 1 or t < EPSILON_BLOCK or t > T_MAX:
                continue
            if best is None or t < best[0]:
                best = (t, i, u, v)
        return best

    # ---- light walks ----

    def _node_importance(self, point, normal, idx, eps):
        ls = self.lights
        nmin, nmax = ls.node_min[idx].astype(np.float64), ls.node_max[idx].astype(np.float64)
        visible = 0.0
        for cx in (nmin[0], nmax[0]):
            for cy in (nmin[1], nmax[1]):
                for cz in (nmin[2], nmax[2]):
                    c = np.array([cx, cy, cz])
                    visible += float((c - point) @ normal >= eps)
        diag = nmax - nmin
        center = 0.5 * (nmin + nmax)
        dist_sq = max(float(diag @ diag), float((center - point) @ (center - point)))
        return float(ls.node_power[idx]) / dist_sq * (visible / 8.0)

    @property
    def _dense(self) -> bool:
        return self.lights.ancestors is not None and self.lights.ancestors.shape[0] > 1

    def _leaf_prob(self, point, normal, leaf, eps):
        """Descent probability of `leaf` = product of normalized importances
        down the root path (dense-path semantics)."""
        ls = self.lights
        path = [int(leaf)]
        while ls.node_parent[path[-1]] != SENTINEL:
            path.append(int(ls.node_parent[path[-1]]))
        path.reverse()
        prob = 1.0
        for i in range(len(path) - 1):
            node, child = path[i], path[i + 1]
            l, r = int(ls.node_left[node]), int(ls.node_right[node])
            il = self._node_importance(point, normal, l, eps)
            ir = self._node_importance(point, normal, r, eps)
            tot = il + ir
            if tot <= 0:
                return 0.0
            prob *= (il if child == l else ir) / tot
        return prob

    def _traverse_dense(self, point, normal, seed):
        """Single-draw CDF inversion over prims in prim order —
        mirrors wavefront.dense_sample_light exactly."""
        ls = self.lights
        if ls.node_left[0] == SENTINEL and ls.node_right[0] == SENTINEL:
            return None
        probs = [
            self._leaf_prob(point, normal, int(ls.leaf_node[q]), EPSILON_BLOCK)
            for q in range(ls.num_prims)
        ]
        total = float(np.sum(np.float32(probs), dtype=np.float32))
        if total <= 0:
            return None
        u = _finalizef(seed) * total
        cum = 0.0
        for q in range(ls.num_prims):
            cum = np.float32(cum + np.float32(probs[q]))
            if cum >= u:
                # first crossing prim column; a zero-probability crossing
                # means failure (mirrors the device's probs>0 pick mask)
                if probs[q] <= 0:
                    return None
                imp = self._node_importance(
                    point, normal, int(ls.leaf_node[q]), EPSILON_BLOCK
                )
                return q, imp
        return None

    def _traverse(self, point, normal, seed):
        if self._dense:
            return self._traverse_dense(point, normal, seed)
        ls = self.lights
        if ls.node_left[0] == SENTINEL and ls.node_right[0] == SENTINEL:
            return None
        node = 0
        importance = (
            self._node_importance(point, normal, 0, EPSILON_BLOCK)
            if ls.node_left[0] == SENTINEL
            else 0.0
        )
        while ls.node_left[node] != SENTINEL:
            l, r = int(ls.node_left[node]), int(ls.node_right[node])
            il = self._node_importance(point, normal, l, EPSILON_BLOCK)
            ir = self._node_importance(point, normal, r, EPSILON_BLOCK)
            tot = il + ir
            nl = il / tot if tot > 0 else 0.0
            if _finalizef(seed) < nl:
                node, importance = l, il
            else:
                node, importance = r, ir
            seed = _combine(seed, 0)
        return int(self.lights.node_right[node]), importance

    def _reverse_prob(self, point, normal, leaf):
        ls = self.lights
        node = int(leaf)
        prob = 1.0
        while ls.node_parent[node] != SENTINEL:
            par = int(ls.node_parent[node])
            l, r = int(ls.node_left[par]), int(ls.node_right[par])
            il = self._node_importance(point, normal, l, EPSILON_NEE)
            ir = self._node_importance(point, normal, r, EPSILON_NEE)
            tot = il + ir
            br = (il if node == l else ir) / tot if tot > 0 else 0.0
            prob *= br
            node = par
        return prob

    def _nee_pdf(self, point, normal, d, mis):
        if mis <= 0.0 or np.all(d == 0):
            return 0.0
        ls = self.lights
        pdf = 0.0
        cos_theta = float(normal @ d)
        hits = 0
        for p in range(ls.num_prims):
            p0 = ls.p0[p].astype(np.float64)
            e1 = ls.e1[p].astype(np.float64)
            e2 = ls.e2[p].astype(np.float64)
            nvec = np.cross(e1, e2)
            denom = d @ nvec
            if abs(denom) < 1e-12:
                continue
            t = ((p0 - point) @ nvec) / denom
            if t < EPSILON_NEE or t > T_MAX:
                continue
            rel = (point + d * t) - p0
            e11, e22, e12 = e1 @ e1, e2 @ e2, e1 @ e2
            det = e11 * e22 - e12 * e12
            r1, r2 = rel @ e1, rel @ e2
            u = (r1 * e22 - r2 * e12) / det
            v = (r2 * e11 - r1 * e12) / det
            if ls.is_tri[p]:
                if u < 0 or v < 0 or u + v > 1:
                    continue
            else:
                if u < 0 or u > 1 or v < 0 or v > 1:
                    continue
            # the device dense path accumulates EVERY crossing (reference
            # nee_pdf.rs:302-334 walks all hits); the sparse path collects
            # at most settings.max_nee_hits slots — mirror that cap only
            if not self._dense and hits >= self.s.max_nee_hits:
                break
            hits += 1
            # dense path evaluates the pdf walk with the trace epsilon;
            # walk path mirrors the reference's nee epsilon (nee_pdf.rs:15)
            if self._dense:
                walk = self._leaf_prob(
                    point, normal, ls.leaf_node[p], EPSILON_BLOCK
                )
            else:
                walk = self._reverse_prob(point, normal, ls.leaf_node[p])
            pdf += walk * t * t / (cos_theta * float(ls.area[p]))
        return pdf

    # ---- shading ----

    def _sample_tex(self, tex, kind, u, v):
        size = TEX_SIZE
        ti = min(max(int(u * size), 0), size - 1)
        tj = min(max(int(v * size), 0), size - 1)
        return self.reg.atlas[tex, kind, tj, ti].astype(np.float64)

    def _shade(self, o, d, seed, bounce, nee_type):
        """Returns (new_o, new_d, normal, emis, refl, mis, bsdf_pdf)."""
        zero3 = np.zeros(3)
        if np.all(d == 0):
            return o, zero3, zero3, zero3, zero3, 0.0, 1.0

        vox = self._dda(o, d)
        tri = self._tri_hit(o, d)
        use_tri = tri is not None and (vox is None or tri[0] < vox[0])

        if vox is None and tri is None:
            sky = SKY_EMISSION if d[1] > SKY_COS_CUTOFF else 0.0
            return (
                o + d * MISS_DISTANCE, zero3, zero3,
                np.full(3, sky), zero3, 0.0, 1.0,
            )

        if use_tri:
            t, i, bu, bv = tri
            v0, v1, v2 = self.tri_verts[i]
            e1, e2 = v1 - v0, v2 - v0
            normal = np.cross(e1, e2)
            normal = normal / np.linalg.norm(normal)
            tangent = e1 / np.linalg.norm(e1)
            bitangent = np.cross(normal, tangent)
            bitangent = bitangent / np.linalg.norm(bitangent)
            bary = np.array([1 - bu - bv, bu, bv])
            uv = (self.tri_uv[i] * bary[:, None]).sum(0)
            u, v = float(uv[0]), float(uv[1])
            tex = int(self.tri_tex[i])
            hit_point = o + d * t
        else:
            t, owner, face, voxv = vox
            normal = _FACE_NORMAL[face]
            tangent = _FACE_TANGENT[face]
            bitangent = np.cross(normal, tangent)
            hit_point = o + d * t
            local = hit_point - (voxv + self.origin)
            lx, ly, lz = local
            u, v = [
                (1 - lz, 1 - ly),
                (lz, 1 - ly),
                (lx, lz),
                (1 - lx, lz),
                (lx, 1 - ly),
                (1 - lx, 1 - ly),
            ][face]
            tex = owner * 6 + face

        tex0 = self._sample_tex(tex, 0, u, v)
        tex1 = self._sample_tex(tex, 1, u, v)
        tex2 = self._sample_tex(tex, 2, u, v)
        reflectivity = tex0[:3].copy()
        alpha = tex0[3]
        emissivity = EMISSION_SCALE * tex1[:3] * (-(d @ normal))
        metallicity = tex2[0]

        scatter_rand = _finalizef(_combine(seed, 0))
        mis_weight = 0.0
        if scatter_rand < metallicity:
            new_d = d - 2 * (d @ normal) * normal
            return hit_point, new_d, normal, emissivity, reflectivity, 0.0, 1.0
        if scatter_rand < metallicity + (1.0 - alpha):
            return hit_point, d, normal, emissivity, np.ones(3), 0.0, 1.0

        new_o = hit_point + EPSILON_BLOCK * 1.5 * normal
        reflectivity = reflectivity / _PI

        result = None
        if nee_type == 1 or (nee_type == 2 and bounce == 0):
            result = self._traverse(new_o, normal, _combine(seed, 2))
        if result is not None and result[1] > 0.0:
            mis_weight = NEE_MIS_WEIGHT

        mis_rand = _finalizef(_combine(seed, 3))
        u4 = _finalizef(_combine(seed, 4))
        u5 = _finalizef(_combine(seed, 5))
        if mis_rand < mis_weight:
            prim = result[0]
            ls = self.lights
            p0 = ls.p0[prim].astype(np.float64)
            e1 = ls.e1[prim].astype(np.float64)
            e2 = ls.e2[prim].astype(np.float64)
            uu, vv = u4, u5
            if ls.is_tri[prim] and uu + vv > 1.0:
                uu, vv = 1.0 - uu, 1.0 - vv
            lp = p0 + uu * e1 + vv * e2
            new_d = lp - new_o
            new_d = new_d / np.linalg.norm(new_d)
        else:
            theta = 2.0 * _PI * u4
            r = math.sqrt(max(0.0, 1.0 - u5))
            h = np.array([r * math.cos(theta), math.sqrt(u5), r * math.sin(theta)])
            new_d = h[0] * tangent + h[1] * normal + h[2] * bitangent
            new_d = new_d / np.linalg.norm(new_d)

        cos_theta = new_d @ normal
        bsdf_pdf = cos_theta / _PI
        return new_o, new_d, normal, emissivity, reflectivity, mis_weight, bsdf_pdf

    # ---- frame ----

    def render(self, eye, front, right, up, frame_count=0, nee_type=0):
        s = self.s
        w, h = s.render_width, s.render_height
        b_total = s.num_bounces
        aspect = w / h
        img = np.zeros((h, w, 3))

        for py in range(h):
            for px in range(w):
                u = 2.0 * px / w - 1.0
                v = 2.0 * py / h - 1.0
                d = u * np.asarray(right) * aspect + v * np.asarray(up) + np.asarray(front)
                d = d / np.linalg.norm(d)
                o = np.asarray(eye, np.float64)
                rid = py * w + px

                emis, refl, mis, bsdf, nee, valid = [], [], [], [], [], []
                for b in range(b_total):
                    inv_seed = (frame_count * b_total + b) & _M
                    seed = _combine(inv_seed, rid)
                    o, d, normal, e, r, m, bp = self._shade(o, d, seed, b, nee_type)
                    np_pdf = (
                        self._nee_pdf(o, normal, d, m) if nee_type != 0 else 0.0
                    )
                    emis.append(e)
                    refl.append(r)
                    mis.append(m)
                    bsdf.append(bp)
                    nee.append(np_pdf)
                    valid.append(0.0 if np.all(d == 0) else 1.0)

                radiance = np.zeros(3)
                for b in range(b_total - 1, -1, -1):
                    q = nee[b] * mis[b] + (1.0 - mis[b]) * bsdf[b]
                    # zero-probability samples contribute nothing beyond
                    # their emission (documented divergence from the
                    # reference's 0/0 NaN, outgoing_radiance.rs:84; see
                    # wavefront.accumulate_radiance)
                    wgt = bsdf[b] / q if q > 0 else 0.0
                    radiance = emis[b] + refl[b] * radiance * wgt * valid[b]
                img[py, px] = radiance

        if s.scale > 1:
            img = img.reshape(s.height, s.scale, s.width, s.scale, 3).mean(axis=(1, 3))
        return img.astype(np.float32)

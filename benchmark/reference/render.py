"""The reference path tracer: the radiance of chosen pixels of a frame.

One function of the upstream renderer's model (`raygen.rs`,
`raytrace.rs`, `nee_pdf.rs`, `outgoing_radiance.rs`), vectorized over
rays and computed in float64: pinhole rays; per bounce the first voxel
face or entity triangle crossed (a voxel DDA over the whole grid with the
enter/exit rule of translucent blocks; Moller-Trumbore over the
triangles); nearest texel reads; the three-way scatter (mirror by
metallicity, pass-through by alpha, else diffuse); on diffuse hits NEE
with the dense light pick (the product of normalized BVH node
importances down to each prim, inverted once against one draw) and the
one-sample MIS of light and cosine-hemisphere directions; the NEE pdf of
the chosen direction over every light prim it crosses; and the backward
fold of emission and throughput.  Every draw is murmur3 of (frame,
bounce, pixel, draw), as upstream.  The light pick's running sum is kept
in float32, as upstream keeps it; all else is float64.

Only dense light sets (at most 256 prims) are modelled: `Reference`
raises for a larger one.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.lights import SENTINEL, Lights

EPS = 1e-3          # the trace epsilon (raytrace.rs:16)
EPS_NEE = 1e-4      # the NEE pdf epsilon (nee_pdf.rs:15)
T_MAX = 1000.0
MISS_DISTANCE = 5000.0
SKY_EMISSION = 50.0
SKY_COS = 0.9
EMISSION_SCALE = 1000.0
MIS_WEIGHT = 0.3
DENSE_PRIMS = 256
M32 = 0xFFFFFFFF

_NORMAL = [[-1, 0, 0], [1, 0, 0], [0, -1, 0], [0, 1, 0], [0, 0, -1],
           [0, 0, 1]]
_TANGENT = [[0, 1, 0], [0, 1, 0], [0, 0, 1], [0, 0, 1], [1, 0, 0],
            [1, 0, 0]]


def _mul(h, c: int):
    """(h * c) mod 2**32 in int64 without overflow."""
    return ((h * (c & 0xFFFF)) + (((h * (c >> 16)) & 0xFFFF) << 16)) & M32


def combine(h, k):
    h = h ^ _mul(k & M32, 0x1B873593)
    h = ((h << 13) & M32) | (h >> 19)
    return (_mul(h, 5) + 0xE6546B64) & M32


def rand(h):
    """finalize(h) as a float in [0, 1) by mantissa stuffing."""
    h = h ^ (h >> 16)
    h = _mul(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    bits = ((h & 0x7FFFFF) | 0x3F800000).to(torch.int32)
    return bits.view(torch.float32).to(torch.float64) - 1.0


def _dot(a, b):
    return (a * b).sum(-1)


def _unit(v):
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


class Reference:
    """A scene held on `device`: grid (X, Y, Z) uint8 with world origin,
    the block tables, the atlas, the light set and entity triangles."""

    def __init__(self, grid, origin, blocks, lights: Lights, tris=None,
                 device="cpu"):
        dev = torch.device(device)
        self.dev = dev
        self.grid = torch.as_tensor(grid, device=dev).to(torch.int64)
        self.dims = torch.tensor(self.grid.shape, dtype=torch.int64,
                                 device=dev)
        self.origin = torch.tensor(np.asarray(origin, np.float64),
                                   device=dev)
        n = len(blocks.names)
        transparent = np.ones(256, bool)
        translucent = np.ones(256, bool)
        transparent[:n + 1] = blocks.transparent
        translucent[:n + 1] = blocks.translucent
        self.transparent = torch.as_tensor(transparent, device=dev)
        self.translucent = torch.as_tensor(translucent, device=dev)
        self.atlas = torch.as_tensor(blocks.atlas, device=dev).to(
            torch.float64)
        self.face_n = torch.tensor(_NORMAL, dtype=torch.float64, device=dev)
        self.face_t = torch.tensor(_TANGENT, dtype=torch.float64, device=dev)
        if lights.count > DENSE_PRIMS:
            raise ValueError(f"{lights.count} light prims: only dense light "
                             f"sets (<= {DENSE_PRIMS}) are modelled")
        self.lights = lights
        f64 = dict(dtype=torch.float64, device=dev)
        self.p0 = torch.as_tensor(lights.p0, **f64)
        self.e1 = torch.as_tensor(lights.e1, **f64)
        self.e2 = torch.as_tensor(lights.e2, **f64)
        self.l_tri = torch.as_tensor(lights.is_tri, device=dev)
        self.l_area = torch.as_tensor(lights.area, **f64)
        self.n_min = torch.as_tensor(lights.node_min, **f64)
        self.n_max = torch.as_tensor(lights.node_max, **f64)
        self.n_pow = torch.as_tensor(lights.node_power, **f64)
        # each prim's root-to-leaf path as (parent, child) steps
        self.prim_paths = []
        for q in range(lights.count):
            path = [int(lights.leaf[q])]
            while lights.parent[path[-1]] != SENTINEL:
                path.append(int(lights.parent[path[-1]]))
            path.reverse()
            self.prim_paths.append(list(zip(path[:-1], path[1:])))
        if tris is None:
            tris = (np.zeros((0, 3, 3)), np.zeros((0, 3, 2)),
                    np.zeros(0, np.int64))
        self.tv = torch.as_tensor(np.asarray(tris[0], np.float64), device=dev)
        self.tuv = torch.as_tensor(np.asarray(tris[1], np.float64),
                                   device=dev)
        self.ttex = torch.as_tensor(np.asarray(tris[2], np.int64), device=dev)

    # ---- intersection ----

    def _block(self, v):
        inside = ((v >= 0) & (v < self.dims)).all(-1)
        c = torch.where(inside[:, None], v, torch.zeros_like(v))
        b = self.grid[c[:, 0], c[:, 1], c[:, 2]]
        return torch.where(inside, b, torch.full_like(b, 255))

    def dda(self, o, d):
        """First voxel-face crossing of each ray: (hit, t, owner, face,
        voxel); the march follows the scalar DDA step for step."""
        n = o.shape[0]
        dev = self.dev
        hit = torch.zeros(n, dtype=torch.bool, device=dev)
        t_out = torch.zeros(n, dtype=torch.float64, device=dev)
        owner = torch.zeros(n, dtype=torch.int64, device=dev)
        face = torch.zeros(n, dtype=torch.int64, device=dev)
        vox_out = torch.zeros((n, 3), dtype=torch.int64, device=dev)
        dims = self.dims.to(torch.float64)
        p0 = o - self.origin
        fin = d.abs() > 1e-30
        inv = torch.where(fin, 1.0 / torch.where(fin, d, torch.ones_like(d)),
                          torch.full_like(d, math.inf))
        t_lo = (0.0 - p0) * inv
        t_hi = (dims - p0) * inv
        t_near_ax = torch.where(fin, torch.minimum(t_lo, t_hi),
                                torch.full_like(d, -math.inf))
        t_far_ax = torch.where(fin, torch.maximum(t_lo, t_hi),
                               torch.full_like(d, math.inf))
        t_near = t_near_ax.max(-1).values
        t_far = t_far_ax.min(-1).values
        t_entry = torch.clamp(t_near, min=EPS)
        limit = torch.clamp(t_far, max=T_MAX)
        live = ~(t_entry > limit)
        step = torch.sign(d).to(torch.int64)
        vox = torch.floor(p0 + d * (t_entry + 1e-4)[:, None]).to(torch.int64)
        back = t_near > EPS
        ax0 = t_near_ax.argmax(-1)
        vox[back, ax0[back]] -= step[back, ax0[back]]
        idx = torch.nonzero(live).squeeze(1)
        vox, step, inv, p0, limit = (vox[idx], step[idx], inv[idx], p0[idx],
                                     limit[idx])
        fin = fin[idx]
        cur = self._block(vox)
        up = (step > 0).to(torch.int64)
        for _ in range(8 * int(self.dims.max())):
            if idx.numel() == 0:
                break
            tmax = torch.where(fin, ((vox + up).to(torch.float64) - p0) * inv,
                               torch.full_like(p0, math.inf))
            ax = tmax.argmin(-1)
            t = tmax.gather(1, ax[:, None]).squeeze(1)
            gone = t > limit
            nvox = vox.clone()
            sa = step.gather(1, ax[:, None]).squeeze(1)
            nvox.scatter_add_(1, ax[:, None], sa[:, None])
            nxt = self._block(nvox)
            enter = ~self.transparent[nxt] & self.translucent[cur]
            leave = ~self.transparent[cur] & self.translucent[nxt]
            stop = ~gone & (t >= EPS) & (enter | leave)
            pos = sa > 0
            f = torch.where(enter, ax * 2 + (~pos).to(torch.int64),
                            ax * 2 + pos.to(torch.int64))
            hit[idx[stop]] = True
            t_out[idx[stop]] = t[stop]
            owner[idx[stop]] = torch.where(enter, nxt, cur)[stop]
            face[idx[stop]] = f[stop]
            vox_out[idx[stop]] = torch.where(enter[:, None], nvox, vox)[stop]
            inside = ((nvox >= 0) & (nvox < self.dims)).all(-1)
            keep = ~gone & ~stop & inside
            k = torch.nonzero(keep).squeeze(1)
            idx, vox, cur = idx[k], nvox[k], nxt[k]
            step, inv, p0, limit, fin, up = (step[k], inv[k], p0[k],
                                             limit[k], fin[k], up[k])
        return hit, t_out, owner, face, vox_out

    def tri_hit(self, o, d):
        """Nearest entity triangle crossed: (hit, t, index, bary u, v)."""
        n = o.shape[0]
        if self.tv.shape[0] == 0:
            z = torch.zeros(n, dtype=torch.float64, device=self.dev)
            return (torch.zeros(n, dtype=torch.bool, device=self.dev), z,
                    torch.zeros(n, dtype=torch.int64, device=self.dev), z, z)
        v0, v1, v2 = self.tv[:, 0], self.tv[:, 1], self.tv[:, 2]
        e1, e2 = (v1 - v0)[None], (v2 - v0)[None]
        dd = d[:, None, :]
        p = torch.linalg.cross(dd.expand(-1, e2.shape[1], -1),
                               e2.expand(n, -1, -1))
        det = _dot(e1, p)
        ok = det.abs() >= 1e-12
        det = torch.where(ok, det, torch.ones_like(det))
        tv = o[:, None, :] - v0[None]
        u = _dot(tv, p) / det
        q = torch.linalg.cross(tv, e1.expand(n, -1, -1))
        v = _dot(dd, q) / det
        t = _dot(e2, q) / det
        ok = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t >= EPS) \
            & (t <= T_MAX)
        t = torch.where(ok, t, torch.full_like(t, math.inf))
        i = t.argmin(-1)
        pick = lambda a: a.gather(1, i[:, None]).squeeze(1)  # noqa: E731
        tb = pick(t)
        return torch.isfinite(tb), tb, i, pick(u), pick(v)

    # ---- lights ----

    def _importance(self, point, normal, eps, nodes=None):
        """(N, M) importance of the nodes seen from each point."""
        nmin = self.n_min if nodes is None else self.n_min[nodes]
        nmax = self.n_max if nodes is None else self.n_max[nodes]
        npow = self.n_pow if nodes is None else self.n_pow[nodes]
        vis = torch.zeros(point.shape[0], nmin.shape[0], dtype=torch.float64,
                          device=self.dev)
        for cx in (nmin[:, 0], nmax[:, 0]):
            for cy in (nmin[:, 1], nmax[:, 1]):
                for cz in (nmin[:, 2], nmax[:, 2]):
                    c = torch.stack([cx, cy, cz], -1)[None]
                    vis += (_dot(c - point[:, None], normal[:, None])
                            >= eps).to(torch.float64)
        diag = nmax - nmin
        center = 0.5 * (nmin + nmax)
        dist = torch.maximum(_dot(diag, diag)[None],
                             _dot(center[None] - point[:, None],
                                  center[None] - point[:, None]))
        return npow[None] / dist * (vis / 8.0)

    def _prim_probs(self, point, normal, eps):
        """(N, P) descent probability of each prim: the product of the
        normalized importance of each step down its path (0 where a
        step's pair sums to 0)."""
        imp = self._importance(point, normal, eps)
        lt = self.lights
        out = []
        for path in self.prim_paths:
            prob = torch.ones(point.shape[0], dtype=torch.float64,
                              device=self.dev)
            for par, child in path:
                il = imp[:, int(lt.left[par])]
                ir = imp[:, int(lt.right[par])]
                tot = il + ir
                share = torch.where(tot > 0, (il if child == lt.left[par]
                                              else ir) / torch.where(
                    tot > 0, tot, torch.ones_like(tot)),
                    torch.zeros_like(tot))
                prob = prob * share
            out.append(prob)
        return torch.stack(out, -1), imp

    def light_pick(self, point, normal, seed):
        """Dense pick: (chosen prim or -1, its leaf importance > 0)."""
        n = point.shape[0]
        none = torch.full((n,), -1, dtype=torch.int64, device=self.dev)
        if self.lights.count == 0:
            return none, torch.zeros(n, dtype=torch.bool, device=self.dev)
        probs, imp = self._prim_probs(point, normal, EPS)
        p32 = probs.to(torch.float32)
        total = torch.zeros(n, dtype=torch.float32, device=self.dev)
        for q in range(p32.shape[1]):
            total = total + p32[:, q]
        u = rand(seed).to(torch.float32) * total
        cum = torch.zeros(n, dtype=torch.float32, device=self.dev)
        chosen = none.clone()
        for q in range(p32.shape[1]):
            cum = cum + p32[:, q]
            first = (chosen == -1) & (cum >= u)
            chosen = torch.where(first, torch.full_like(chosen, q), chosen)
        found = chosen >= 0
        cq = chosen.clamp(min=0)
        ok = found & (total > 0) & (probs.gather(1, cq[:, None]).squeeze(1)
                                    > 0)
        leaf = torch.as_tensor(self.lights.leaf, device=self.dev)[cq]
        good = ok & (imp.gather(1, leaf[:, None]).squeeze(1) > 0)
        return torch.where(ok, chosen, none), good

    def nee_pdf(self, point, normal, d):
        """Sum over every light prim the direction crosses of its pick
        probability x t^2 / (cos x area)."""
        n = point.shape[0]
        pdf = torch.zeros(n, dtype=torch.float64, device=self.dev)
        if self.lights.count == 0:
            return pdf
        probs, _ = self._prim_probs(point, normal, EPS)
        cos = _dot(normal, d)
        for p in range(self.lights.count):
            p0, e1, e2 = self.p0[p], self.e1[p], self.e2[p]
            nv = torch.linalg.cross(e1, e2)
            den = _dot(d, nv)
            ok = den.abs() >= 1e-12
            t = _dot(p0 - point, nv) / torch.where(ok, den,
                                                   torch.ones_like(den))
            ok = ok & (t >= EPS_NEE) & (t <= T_MAX)
            rel = (point + d * t[:, None]) - p0
            e11, e22, e12 = _dot(e1, e1), _dot(e2, e2), _dot(e1, e2)
            det = e11 * e22 - e12 * e12
            r1, r2 = _dot(rel, e1), _dot(rel, e2)
            u = (r1 * e22 - r2 * e12) / det
            v = (r2 * e11 - r1 * e12) / det
            if bool(self.lights.is_tri[p]):
                ok = ok & (u >= 0) & (v >= 0) & (u + v <= 1)
            else:
                ok = ok & (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1)
            term = probs[:, p] * t * t / (cos * self.l_area[p])
            pdf = pdf + torch.where(ok, term, torch.zeros_like(term))
        return pdf

    # ---- shading ----

    def _texel(self, tex, kind, u, v):
        ti = (u * 16).trunc().clamp(0, 15).to(torch.int64)
        tj = (v * 16).trunc().clamp(0, 15).to(torch.int64)
        return self.atlas[tex, kind, tj, ti]

    def bounce(self, o, d, seed, nee: bool):
        """One bounce of every ray: (new o, new d, emission, reflectivity,
        mis, bsdf pdf, nee pdf).  A dead ray (d = 0) adds nothing."""
        n = o.shape[0]
        z3 = torch.zeros_like(o)
        zero = torch.zeros(n, dtype=torch.float64, device=self.dev)
        one = torch.ones_like(zero)
        alive = (d != 0).any(-1)
        vh, vt, owner, face, vox = self.dda(o, d)
        th, tt, ti, tu, tv = self.tri_hit(o, d)
        vh, th = vh & alive, th & alive
        use_tri = th & (~vh | (tt < vt))
        hit = vh | th
        t = torch.where(use_tri, tt, vt)
        hp = o + d * t[:, None]
        # voxel frame and uv
        f = face
        nrm = self.face_n[f]
        tan = self.face_t[f]
        loc = hp - (vox.to(torch.float64) + self.origin)
        lx, ly, lz = loc[:, 0], loc[:, 1], loc[:, 2]
        us = torch.stack([1 - lz, lz, lx, 1 - lx, lx, 1 - lx], -1)
        vs = torch.stack([1 - ly, 1 - ly, lz, lz, 1 - ly, 1 - ly], -1)
        u = us.gather(1, f[:, None]).squeeze(1)
        v = vs.gather(1, f[:, None]).squeeze(1)
        tex = owner * 6 + f
        if self.tv.shape[0]:
            tri = self.tv[ti]
            e1, e2 = tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
            tn = _unit(torch.linalg.cross(e1, e2))
            tt_ = e1 / torch.linalg.norm(e1, dim=-1, keepdim=True)
            bary = torch.stack([1 - tu - tv, tu, tv], -1)
            uv = (self.tuv[ti] * bary[:, :, None]).sum(1)
            m = use_tri[:, None]
            nrm = torch.where(m, tn, nrm)
            tan = torch.where(m, tt_, tan)
            u = torch.where(use_tri, uv[:, 0], u)
            v = torch.where(use_tri, uv[:, 1], v)
            tex = torch.where(use_tri, self.ttex[ti], tex)
        bit = torch.linalg.cross(nrm, tan)
        bit = torch.where(use_tri[:, None], _unit(bit), bit)
        tex = torch.where(hit, tex, torch.zeros_like(tex))
        t0 = self._texel(tex, 0, u, v)
        t1 = self._texel(tex, 1, u, v)
        t2 = self._texel(tex, 2, u, v)
        refl = t0[:, :3]
        alpha = t0[:, 3]
        emis = EMISSION_SCALE * t1[:, :3] * (-_dot(d, nrm))[:, None]
        metal = t2[:, 0]
        sr = rand(combine(seed, 0))
        mirror = hit & (sr < metal)
        passing = hit & ~mirror & (sr < metal + (1.0 - alpha))
        diffuse = hit & ~mirror & ~passing
        new_o = hp + EPS * 1.5 * nrm
        # NEE pick on diffuse hits
        mis = zero.clone()
        chosen = torch.full((n,), -1, dtype=torch.int64, device=self.dev)
        if nee:
            di = torch.nonzero(diffuse).squeeze(1)
            if di.numel():
                c, good = self.light_pick(new_o[di], nrm[di],
                                          combine(seed[di], 2))
                chosen[di] = torch.where(good, c, torch.full_like(c, -1))
                mis[di] = torch.where(good, torch.full_like(mis[di],
                                                            MIS_WEIGHT),
                                      torch.zeros_like(mis[di]))
        mr = rand(combine(seed, 3))
        u4 = rand(combine(seed, 4))
        u5 = rand(combine(seed, 5))
        to_light = diffuse & (mr < mis)
        cq = chosen.clamp(min=0)
        uu, vv = u4.clone(), u5.clone()
        fold = to_light & self.l_tri[cq] & (uu + vv > 1.0) \
            if self.lights.count else torch.zeros_like(to_light)
        uu = torch.where(fold, 1.0 - uu, uu)
        vv = torch.where(fold, 1.0 - vv, vv)
        if self.lights.count:
            lp = self.p0[cq] + uu[:, None] * self.e1[cq] \
                + vv[:, None] * self.e2[cq]
            ld = _unit(lp - new_o)
        else:
            ld = z3
        theta = 2.0 * math.pi * u4
        r = torch.sqrt(torch.clamp(1.0 - u5, min=0.0))
        h0, h1, h2 = r * torch.cos(theta), torch.sqrt(u5), r * torch.sin(theta)
        hd = _unit(h0[:, None] * tan + h1[:, None] * nrm + h2[:, None] * bit)
        dd = torch.where(to_light[:, None], ld, hd)
        bsdf = _dot(dd, nrm) / math.pi
        reflect = d - 2 * _dot(d, nrm)[:, None] * nrm
        # outputs by case: miss, mirror, pass-through, diffuse, dead
        miss = alive & ~hit
        sky = torch.where(d[:, 1] > SKY_COS, torch.full_like(zero,
                                                             SKY_EMISSION),
                          zero)
        out_o = torch.where(miss[:, None], o + d * MISS_DISTANCE,
                            torch.where(diffuse[:, None], new_o, hp))
        out_o = torch.where(alive[:, None], out_o, o)
        out_d = torch.where(mirror[:, None], reflect,
                            torch.where(passing[:, None], d,
                                        torch.where(diffuse[:, None], dd,
                                                    z3)))
        out_e = torch.where(hit[:, None], emis,
                            torch.where(miss[:, None], sky[:, None]
                                        .expand(-1, 3), z3))
        out_r = torch.where(diffuse[:, None], refl / math.pi,
                            torch.where(mirror[:, None], refl,
                                        torch.where(passing[:, None],
                                                    torch.ones_like(refl),
                                                    z3)))
        out_b = torch.where(diffuse, bsdf, one)
        pdf = zero.clone()
        if nee:
            ni = torch.nonzero(mis > 0).squeeze(1)
            if ni.numel():
                pdf[ni] = self.nee_pdf(new_o[ni], nrm[ni], dd[ni])
        return out_o, out_d, out_e, out_r, mis, out_b, pdf

    def rays(self, pixels, width: int, height: int, basis):
        """Pinhole rays (o, d) of the pixel ids (y * width + x)."""
        pid = torch.as_tensor(np.asarray(pixels, np.int64), device=self.dev)
        x = (pid % width).to(torch.float64)
        y = (pid // width).to(torch.float64)
        u = 2.0 * x / width - 1.0
        v = 2.0 * y / height - 1.0

        def vec(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=self.dev)

        d = _unit(u[:, None] * vec(basis.right) * (width / height)
                  + v[:, None] * vec(basis.up) + vec(basis.front))
        return vec(basis.eye).expand(pid.shape[0], 3).clone(), d

    def paths(self, o, d, pixels, frame_counts, bounces: int,
              nee_type: int):
        """(N, 3) float64 radiance of rays (o, d) of the given pixel ids
        and frame counts; nee_type 1 samples lights on every bounce, 2 on
        the first only, 0 never."""
        pid = torch.as_tensor(np.asarray(pixels, np.int64), device=self.dev)
        fc = torch.as_tensor(np.asarray(frame_counts, np.int64) & M32,
                             device=self.dev)
        terms = []
        for b in range(bounces):
            seed = combine((fc * bounces + b) & M32, pid)
            nee = nee_type == 1 or (nee_type == 2 and b == 0)
            o, d, e, r, m, bp, npdf = self.bounce(o, d, seed, nee)
            terms.append((e, r, m, bp, npdf, (d != 0).any(-1)))
        rad = torch.zeros_like(o)
        for e, r, m, bp, npdf, valid in reversed(terms):
            q = npdf * m + (1.0 - m) * bp
            w = torch.where(q > 0, bp / torch.where(q > 0, q,
                                                    torch.ones_like(q)),
                            torch.zeros_like(q))
            rad = e + r * rad * (w * valid)[:, None]
        return rad

    def radiance(self, pixels, width: int, height: int, basis,
                 frame_count: int, bounces: int, nee_type: int):
        """(len(pixels), 3) float64 radiance of pixel ids of one frame."""
        o, d = self.rays(pixels, width, height, basis)
        fc = np.full(len(pixels), int(frame_count), np.int64)
        return self.paths(o, d, pixels, fc, bounces, nee_type)

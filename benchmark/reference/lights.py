"""The reference's light set: emissive face rectangles and their BVH.

The rules of the upstream light builder (`scene.rs:546-726`: a face is a
light when it exists by the mesher's rule and its emissive texture has
luminance, power = luminance x area; `bvh/build.rs`: binned SAH over 32
bins, one-prim leaves, bottom-up power, parent links) with the program's
documented departures from upstream: one global BVH, coplanar runs of
unit faces merged greedily into rectangles, and voxel prims kept as
quads.  Plain NumPy; the prims and nodes come out in the order the
program's builder makes them, which the dense light pick depends on.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from benchmark.reference.world import FACE_AXIS, FACE_SIGN, Blocks

SENTINEL = 0xFFFFFFFF
_PAD = 1e-4
_BINS = 32


@dataclass
class Lights:
    p0: np.ndarray       # (P, 3) float32
    e1: np.ndarray
    e2: np.ndarray
    is_tri: np.ndarray   # (P,) bool
    area: np.ndarray     # (P,) float32
    leaf: np.ndarray     # (P,) leaf node of each prim
    left: np.ndarray     # (M,) int64, SENTINEL on leaves
    right: np.ndarray    # (M,) int64, the prim on leaves
    parent: np.ndarray   # (M,) int64, SENTINEL at the root
    node_min: np.ndarray  # (M, 3) float32
    node_max: np.ndarray
    node_power: np.ndarray  # (M,) float32

    @property
    def count(self) -> int:
        return len(self.p0)


def _rects(mask: np.ndarray):
    """Greedy rectangle cover (rows then columns) of a 2-D mask."""
    m = mask.copy()
    out = []
    rows, cols = m.shape
    for r in range(rows):
        c = 0
        while c < cols:
            if not m[r, c]:
                c += 1
                continue
            w = 1
            while c + w < cols and m[r, c + w]:
                w += 1
            h = 1
            while r + h < rows and m[r + h, c:c + w].all():
                h += 1
            m[r:r + h, c:c + w] = False
            out.append((r, c, h, w))
            c += w
    return out


def voxel_lights(grid: np.ndarray, origin, blocks: Blocks):
    """(p0, e1, e2, power) of the grid's emissive face rectangles, world
    coordinates, float32: per luminous block and face, each slice along
    the face's axis covered greedily."""
    lum = blocks.luminance.reshape(-1, 6)
    air = blocks.air
    org = np.asarray(origin, np.float32)
    p0s, e1s, e2s, pw = [], [], [], []
    for b in np.where(lum.sum(1) > 0)[0]:
        is_b = grid == b
        if not is_b.any():
            continue
        for face in range(6):
            if lum[b, face] <= 0:
                continue
            ax, sg = int(FACE_AXIS[face]), int(FACE_SIGN[face])
            nb = np.full(grid.shape, air, grid.dtype)
            n = grid.shape[ax]
            dst, src = [slice(None)] * 3, [slice(None)] * 3
            if sg > 0:
                dst[ax], src[ax] = slice(0, n - 1), slice(1, n)
            else:
                dst[ax], src[ax] = slice(1, n), slice(0, n - 1)
            nb[tuple(dst)] = grid[tuple(src)]
            exists = is_b & blocks.translucent[nb]
            if not exists.any():
                continue
            a1, a2 = [a for a in range(3) if a != ax]
            for s in range(n):
                sl = [slice(None)] * 3
                sl[ax] = s
                m2 = exists[tuple(sl)]
                if not m2.any():
                    continue
                for r0, c0, h, w in _rects(m2):
                    corner = np.zeros(3, np.float32)
                    corner[ax] = s + (1.0 if sg > 0 else 0.0)
                    corner[a1], corner[a2] = r0, c0
                    e1 = np.zeros(3, np.float32)
                    e2 = np.zeros(3, np.float32)
                    e1[a1], e2[a2] = h, w
                    p0s.append(corner + org)
                    e1s.append(e1)
                    e2s.append(e2)
                    pw.append(np.float32(lum[b, face] * h * w))
    if not p0s:
        z = np.zeros((0, 3), np.float32)
        return z, z, z, np.zeros(0, np.float32)
    return (np.stack(p0s), np.stack(e1s), np.stack(e2s),
            np.asarray(pw, np.float32))


def _sah(pmin, pmax, cent):
    """Binned SAH build, children made in pairs, the left one pushed
    first and the right one popped first: node lists and prim leaves."""
    left, right, parent, nmin, nmax = [], [], [], [], []
    leaf = np.zeros(len(pmin), np.int64)

    def area(lo, hi):
        d = np.maximum(hi - lo, 0.0)
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    def node(par):
        left.append(SENTINEL)
        right.append(SENTINEL)
        parent.append(par)
        nmin.append(np.zeros(3, np.float32))
        nmax.append(np.zeros(3, np.float32))
        return len(left) - 1

    stack = [(node(SENTINEL), np.arange(len(pmin)))]
    while stack:
        nd, prims = stack.pop()
        if len(prims) == 1:
            nmin[nd], nmax[nd] = pmin[prims[0]], pmax[prims[0]]
            right[nd] = int(prims[0])
            leaf[prims[0]] = nd
            continue
        nmin[nd] = pmin[prims].min(0) - _PAD
        nmax[nd] = pmax[prims].max(0) + _PAD
        if len(prims) == 2:
            ls, rs = prims[:1], prims[1:]
        else:
            c = cent[prims]
            best = (np.inf, None)
            for ax in range(3):
                lo, hi = c[:, ax].min(), c[:, ax].max()
                if hi - lo < 1e-12:
                    continue
                scale = _BINS / (hi - lo)
                bins = np.minimum(_BINS - 1,
                                  ((c[:, ax] - lo) * scale).astype(np.int64))
                for plane in range(1, _BINS):
                    lm = bins < plane
                    nl, nr = lm.sum(), (~lm).sum()
                    if nl == 0 or nr == 0:
                        continue
                    cost = (area(pmin[prims[lm]].min(0),
                                 pmax[prims[lm]].max(0)) * nl
                            + area(pmin[prims[~lm]].min(0),
                                   pmax[prims[~lm]].max(0)) * nr)
                    if cost < best[0]:
                        best = (cost, (ax, plane, lo, scale))
            if best[1] is None:
                half = len(prims) // 2
                ls, rs = prims[:half], prims[half:]
            else:
                ax, plane, lo, scale = best[1]
                bins = np.minimum(
                    _BINS - 1,
                    ((cent[prims][:, ax] - lo) * scale).astype(np.int64))
                ls, rs = prims[bins < plane], prims[bins >= plane]
        li, ri = node(nd), node(nd)
        left[nd], right[nd] = li, ri
        stack.append((li, ls))
        stack.append((ri, rs))
    return (np.asarray(left, np.int64), np.asarray(right, np.int64),
            np.asarray(parent, np.int64), np.stack(nmin), np.stack(nmax),
            leaf)


def light_set(grid: np.ndarray, origin, blocks: Blocks,
              tris=None) -> Lights:
    """The light set of a voxel grid plus emissive entity triangles
    (`tris`: (verts (T,3,3), power (T,)), world space)."""
    p0, e1, e2, power = voxel_lights(grid, origin, blocks)
    is_tri = np.zeros(len(p0), bool)
    if tris is not None and len(tris[0]):
        tv, tp = tris
        p0 = np.concatenate([p0, tv[:, 0].astype(np.float32)])
        e1 = np.concatenate([e1, (tv[:, 1] - tv[:, 0]).astype(np.float32)])
        e2 = np.concatenate([e2, (tv[:, 2] - tv[:, 0]).astype(np.float32)])
        power = np.concatenate([power, np.asarray(tp, np.float32)])
        is_tri = np.concatenate([is_tri, np.ones(len(tv), bool)])
    p = len(p0)
    if p == 0:
        z = np.zeros((1, 3), np.float32)
        return Lights(p0, e1, e2, is_tri, np.zeros(0, np.float32),
                      np.zeros(0, np.int64), np.array([SENTINEL]),
                      np.array([SENTINEL]), np.array([SENTINEL]), z, z,
                      np.zeros(1, np.float32))
    area = np.linalg.norm(np.cross(e1, e2), axis=-1)
    area = np.where(is_tri, 0.5 * area, area).astype(np.float32)
    quad = np.where(is_tri[:, None], 0.0, 1.0)
    corners = np.stack([p0, p0 + e1, p0 + e2, p0 + quad * (e1 + e2)], 1)
    pmin = corners.min(1).astype(np.float32)
    pmax = corners.max(1).astype(np.float32)
    left, right, parent, nmin, nmax, leaf = _sah(pmin, pmax,
                                                 0.5 * (pmin + pmax))
    npow = np.zeros(len(left), np.float32)
    is_leaf = left == SENTINEL
    npow[is_leaf] = power[right[is_leaf]]
    for i in range(len(left) - 1, -1, -1):
        if not is_leaf[i]:
            npow[i] = npow[left[i]] + npow[right[i]]
    return Lights(p0, e1, e2, is_tri, area, leaf, left, right, parent,
                  nmin.astype(np.float32), nmax.astype(np.float32), npow)


def emissive_tris(verts, tex, blocks: Blocks):
    """(triangles, power) of the emissive ones among entity triangles:
    luminance of the texture slot times area."""
    lum = blocks.luminance[np.clip(tex, 0, len(blocks.luminance) - 1)]
    m = lum > 0
    tv = verts[m]
    area = 0.5 * np.linalg.norm(np.cross(tv[:, 1] - tv[:, 0],
                                         tv[:, 2] - tv[:, 0]), axis=-1)
    return tv, (lum[m] * area).astype(np.float32)

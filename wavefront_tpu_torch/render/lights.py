"""Light extraction + power-weighted light BVH.

Reference: src/render_system/bvh/build.rs (binned-SAH builder, 32 bins,
surface-area cost, 1-primitive leaves, bottom-up power aggregation, parent
pointers for the shader's reverse walk) and scene.rs:546-726 (emissive
primitive detection by texture luminance; power = luminance * area).

Divergences from the reference (the same as the JAX package's, so both
packages build the same light set):
  * ONE global BVH over all light primitives in the loaded window, instead
    of a two-level TLAS/BLAS (the reference's split exists because Vulkan AS
    builds are per-object; a flat array rebuild is cheap and removes the
    instance hop from both device walks).
  * Voxel light primitives are the emissive *face quads* themselves rather
    than their two triangles (Vulkan requires triangles; a rectangle is the
    native shape here).  Dynamic entity lights remain triangles.  Both are
    stored as (p0, e1, e2, is_tri): point = p0 + u*e1 + v*e2, with the
    triangle fold u+v>1 applied only when is_tri.

The flattened node arrays carry the same per-node fields as the reference's
48-byte BvhNode (bvh/mod.rs:6-38): left child, right child / prim index
(leaf iff left == SENTINEL), aabb min/max, power, parent index.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from wavefront_tpu_torch.world.blocks import FACE_AXIS, FACE_SIGN, BlockRegistry

SENTINEL = np.uint32(0xFFFFFFFF)
_PAD = 1e-4  # aabb padding, reference build.rs:300,430
_BINS = 32   # reference build.rs:52


def _bucket(n: int, lo: int) -> int:
    """Next power-of-two capacity >= max(n, lo); table shapes quantize to
    buckets (the shade kernel's prim count is one of them)."""
    b = lo
    while b < n:
        b *= 2
    return b


@dataclass
class LightSet:
    """Flattened light primitives + BVH, ready for device upload.

    Arrays are padded to power-of-two buckets.  When the node bucket is small enough (dense_threshold), an
    `ancestors` 0/1 matrix (M, P) is built with A[a, p] = 1 iff node a lies
    on the root->leaf(p) path (a != root, leaf included): it turns the
    per-PRIM descent probability into one matmul (see
    wavefront.dense_prim_probs), eliminating the gather-heavy stochastic/
    reverse walks of the reference shaders (raytrace.rs:230-293,
    nee_pdf.rs:154-228) and letting the NEE-pdf sweep accumulate EVERY
    light-prim crossing exactly (nee_pdf.rs:302-334 walks all hits).
    """

    # primitives
    p0: np.ndarray        # (P, 3) f32
    e1: np.ndarray        # (P, 3) f32
    e2: np.ndarray        # (P, 3) f32
    is_tri: np.ndarray    # (P,) bool
    area: np.ndarray      # (P,) f32
    power: np.ndarray     # (P,) f32
    leaf_node: np.ndarray  # (P,) u32: BVH leaf index of each prim
    num_prims: int
    # flattened BVH (root = node 0)
    node_left: np.ndarray    # (M,) u32
    node_right: np.ndarray   # (M,) u32 (prim idx when leaf)
    node_min: np.ndarray     # (M, 3) f32
    node_max: np.ndarray     # (M, 3) f32
    node_power: np.ndarray   # (M,) f32
    node_parent: np.ndarray  # (M,) u32
    num_nodes: int
    # dense-path data: (M, P) ancestor indicator (or (1, 1) when disabled)
    ancestors: np.ndarray = None
    # per-node prim index for leaf columns, -1 elsewhere (M,)
    leaf_prim: np.ndarray = None
    # per-prim leaf AABBs (P, 3) — exact prim bounds, used by the dense
    # path's elementwise leaf-importance evaluation
    prim_min: np.ndarray = None
    prim_max: np.ndarray = None


def _greedy_rects(mask: np.ndarray):
    """Greedy rectangle cover of a 2-D boolean mask.

    Returns a list of (r0, c0, h, w) rectangles tiling the True cells.
    Classic greedy meshing: grow each uncovered cell rightward then downward.
    """
    m = mask.copy()
    rects = []
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
            while r + h < rows and m[r + h, c : c + w].all():
                h += 1
            m[r : r + h, c : c + w] = False
            rects.append((r, c, h, w))
            c += w
    return rects


def extract_voxel_lights(
    grid: np.ndarray, grid_origin: np.ndarray, registry: BlockRegistry,
    merge: bool = True,
):
    """Emissive face rectangles of the voxel grid, in world coordinates.

    A face is a light primitive iff it exists per the mesher rule (owner not
    completely transparent, neighbor translucent; reference chunk.rs:222-287)
    and its texture luminance is positive (reference scene.rs:563-571).
    Power = luminance * area (reference scene.rs:567-571).

    With merge=True (default), coplanar same-block runs of unit faces are
    greedily merged into large rectangles — radiometrically equivalent for
    uniform-luminance faces (uniform sampling of an h x w rectangle equals
    power-weighted sampling of its h*w unit quads) and it shrinks the light
    BVH by ~an order of magnitude.  The reference cannot do this because its
    light prims must be the BLAS triangles (scene.rs:563-571).

    Returns (p0, e1, e2, power, owner_voxel, face) numpy arrays; for merged
    rectangles owner_voxel is the rectangle's corner voxel.
    """
    lum_by_face = registry.luminance.reshape(registry.num_blocks, 6)
    luminous_blocks = np.where(lum_by_face.sum(axis=1) > 0)[0]

    p0s, e1s, e2s, powers, voxels, faces = [], [], [], [], [], []
    transl = registry.translucent
    origin_f = np.asarray(grid_origin, np.float32)

    for b in luminous_blocks:
        is_b = grid == b
        for face in range(6):
            lum = lum_by_face[b, face]
            if lum <= 0:
                continue
            ax, sg = int(FACE_AXIS[face]), int(FACE_SIGN[face])
            # neighbor block grid along the face direction (outside = air)
            nb = np.full(grid.shape, registry.air, grid.dtype)
            if sg > 0:
                idx_dst = [slice(None)] * 3
                idx_dst[ax] = slice(0, grid.shape[ax] - 1)
                idx_src = [slice(None)] * 3
                idx_src[ax] = slice(1, grid.shape[ax])
                nb[tuple(idx_dst)] = grid[tuple(idx_src)]
            else:
                idx_dst = [slice(None)] * 3
                idx_dst[ax] = slice(1, grid.shape[ax])
                idx_src = [slice(None)] * 3
                idx_src[ax] = slice(0, grid.shape[ax] - 1)
                nb[tuple(idx_dst)] = grid[tuple(idx_src)]
            exists = is_b & transl[nb]
            if not exists.any():
                continue
            a1, a2 = [a for a in range(3) if a != ax]

            if merge:
                # greedy rectangles per face-plane slice
                for s in range(grid.shape[ax]):
                    sl = [slice(None)] * 3
                    sl[ax] = s
                    mask2d = exists[tuple(sl)]  # indexed by (a1, a2)
                    if not mask2d.any():
                        continue
                    for (r0, c0, h, w) in _greedy_rects(mask2d):
                        corner = np.zeros(3, np.float32)
                        corner[ax] = s + (1.0 if sg > 0 else 0.0)
                        corner[a1] = r0
                        corner[a2] = c0
                        e1 = np.zeros(3, np.float32)
                        e2 = np.zeros(3, np.float32)
                        e1[a1] = h
                        e2[a2] = w
                        vox = np.zeros(3, np.int32)
                        vox[ax] = s
                        vox[a1] = r0
                        vox[a2] = c0
                        p0s.append((corner + origin_f)[None])
                        e1s.append(e1[None])
                        e2s.append(e2[None])
                        powers.append(np.float32([lum * h * w]))
                        voxels.append(vox[None])
                        faces.append(np.int32([face]))
            else:
                vx, vy, vz = np.where(exists)
                base = np.stack([vx, vy, vz], -1).astype(np.float32) + origin_f
                corner = base.copy()
                if sg > 0:
                    corner[:, ax] += 1.0
                e1 = np.zeros((len(vx), 3), np.float32)
                e2 = np.zeros((len(vx), 3), np.float32)
                e1[:, a1] = 1.0
                e2[:, a2] = 1.0
                p0s.append(corner)
                e1s.append(e1)
                e2s.append(e2)
                powers.append(np.full(len(vx), lum, np.float32))
                voxels.append(np.stack([vx, vy, vz], -1).astype(np.int32))
                faces.append(np.full(len(vx), face, np.int32))

    if not p0s:
        z3 = np.zeros((0, 3), np.float32)
        return (z3, z3, z3, np.zeros(0, np.float32),
                np.zeros((0, 3), np.int32), np.zeros(0, np.int32))
    return (
        np.concatenate(p0s),
        np.concatenate(e1s),
        np.concatenate(e2s),
        np.concatenate(powers),
        np.concatenate(voxels),
        np.concatenate(faces),
    )


def _sah_build(prim_min, prim_max, prim_centroid):
    """Binned SAH BVH with 1-prim leaves and parent pointers.

    Same algorithm family as the reference builder (build.rs:45-233): 32
    bins per axis, surface-area cost, median fallback when a partition comes
    up empty, recursion to single-primitive leaves.

    Returns (left, right, parent, node_min, node_max, leaf_prim, prim_leaf):
    node SoA lists plus per-prim leaf index.
    """
    n = prim_min.shape[0]
    left, right, parent = [], [], []
    nmin, nmax = [], []
    prim_leaf = np.zeros(n, np.uint32)

    def area(lo, hi):
        d = np.maximum(hi - lo, 0.0)
        return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[2] * d[0])

    def new_node(par):
        idx = len(left)
        left.append(SENTINEL)
        right.append(SENTINEL)
        parent.append(np.uint32(par))
        nmin.append(np.zeros(3, np.float32))
        nmax.append(np.zeros(3, np.float32))
        return idx

    # iterative stack of (node_idx, prim index array)
    root = new_node(SENTINEL)
    stack = [(root, np.arange(n))]
    while stack:
        node, prims = stack.pop()
        lo = prim_min[prims].min(axis=0)
        hi = prim_max[prims].max(axis=0)
        if len(prims) == 1:
            nmin[node] = prim_min[prims[0]]
            nmax[node] = prim_max[prims[0]]
            right[node] = np.uint32(prims[0])
            prim_leaf[prims[0]] = node
            continue
        nmin[node] = lo - _PAD
        nmax[node] = hi + _PAD

        if len(prims) == 2:
            lsel, rsel = prims[:1], prims[1:]
        else:
            cents = prim_centroid[prims]
            best = (np.inf, None, None)
            for ax in range(3):
                cmin, cmax = cents[:, ax].min(), cents[:, ax].max()
                if cmax - cmin < 1e-12:
                    continue
                scale = _BINS / (cmax - cmin)
                bins = np.minimum(
                    (_BINS - 1),
                    ((cents[:, ax] - cmin) * scale).astype(np.int64),
                )
                for plane in range(1, _BINS):
                    lmask = bins < plane
                    cl, cr = lmask.sum(), (~lmask).sum()
                    if cl == 0 or cr == 0:
                        continue
                    la = area(
                        prim_min[prims[lmask]].min(axis=0),
                        prim_max[prims[lmask]].max(axis=0),
                    )
                    ra = area(
                        prim_min[prims[~lmask]].min(axis=0),
                        prim_max[prims[~lmask]].max(axis=0),
                    )
                    cost = la * cl + ra * cr
                    if cost < best[0]:
                        best = (cost, ax, plane, cmin, scale)
            if best[1] is None:
                half = len(prims) // 2
                lsel, rsel = prims[:half], prims[half:]
            else:
                _, ax, plane, cmin, scale = best
                bins = np.minimum(
                    (_BINS - 1),
                    ((prim_centroid[prims][:, ax] - cmin) * scale).astype(np.int64),
                )
                lmask = bins < plane
                lsel, rsel = prims[lmask], prims[~lmask]

        li = new_node(node)
        ri = new_node(node)
        left[node] = np.uint32(li)
        right[node] = np.uint32(ri)
        stack.append((li, lsel))
        stack.append((ri, rsel))

    return (
        np.array(left, np.uint32),
        np.array(right, np.uint32),
        np.array(parent, np.uint32),
        np.stack(nmin),
        np.stack(nmax),
        prim_leaf,
    )


def build_light_set(
    p0: np.ndarray,
    e1: np.ndarray,
    e2: np.ndarray,
    power: np.ndarray,
    is_tri: np.ndarray,
    max_prims: int,
    dense_threshold: int = 512,
) -> LightSet:
    """Build the bucket-padded LightSet (BVH + prim SoA) from raw prims."""
    p = len(p0)
    if p > max_prims:
        raise ValueError(f"{p} light prims exceeds capacity {max_prims}")

    cap_prims = _bucket(max(p, 1), 8)
    cap_nodes = _bucket(max(2 * p - 1, 1), 16)
    dense = cap_nodes <= dense_threshold
    ls = LightSet(
        p0=np.zeros((cap_prims, 3), np.float32),
        e1=np.zeros((cap_prims, 3), np.float32),
        e2=np.zeros((cap_prims, 3), np.float32),
        is_tri=np.zeros(cap_prims, bool),
        area=np.zeros(cap_prims, np.float32),
        power=np.zeros(cap_prims, np.float32),
        leaf_node=np.zeros(cap_prims, np.uint32),
        num_prims=p,
        node_left=np.full(cap_nodes, SENTINEL, np.uint32),
        node_right=np.full(cap_nodes, SENTINEL, np.uint32),
        node_min=np.zeros((cap_nodes, 3), np.float32),
        node_max=np.zeros((cap_nodes, 3), np.float32),
        node_power=np.zeros(cap_nodes, np.float32),
        node_parent=np.full(cap_nodes, SENTINEL, np.uint32),
        num_nodes=0,
        ancestors=np.zeros(
            (cap_nodes, cap_prims) if dense else (1, 1), np.float32
        ),
        leaf_prim=np.full(cap_nodes, -1, np.int32),
        prim_min=np.zeros((cap_prims, 3), np.float32),
        prim_max=np.zeros((cap_prims, 3), np.float32),
    )
    if p == 0:
        # dummy root: left == right == SENTINEL signals "no lights"
        # (reference scene.rs builds a dummy TL node; raytrace.rs:235 checks)
        ls.num_nodes = 1
        return ls

    cross = np.cross(e1, e2)
    area = np.linalg.norm(cross, axis=-1)
    area = np.where(is_tri, 0.5 * area, area).astype(np.float32)

    corners = np.stack([p0, p0 + e1, p0 + e2, p0 + np.where(is_tri[:, None], 0.0, 1.0) * (e1 + e2)], axis=1)
    pmin = corners.min(axis=1).astype(np.float32)
    pmax = corners.max(axis=1).astype(np.float32)
    cent = 0.5 * (pmin + pmax)

    l, r, par, nmin, nmax, prim_leaf = _sah_build(pmin, pmax, cent)
    m = len(l)

    # bottom-up power aggregation (reference build.rs:341-357): nodes are in
    # creation order with children after parents, so reverse order works.
    npow = np.zeros(m, np.float32)
    leaf_mask = l == SENTINEL
    # the dense path relies on sibling pairs being adjacent (li+1 == ri),
    # which the builder guarantees by creating children consecutively
    assert np.all(r[~leaf_mask] == l[~leaf_mask] + 1), "sibling adjacency"
    npow[leaf_mask] = power[r[leaf_mask].astype(np.int64)]
    for i in range(m - 1, -1, -1):
        if not leaf_mask[i]:
            npow[i] = npow[int(l[i])] + npow[int(r[i])]

    ls.p0[:p] = p0
    ls.e1[:p] = e1
    ls.e2[:p] = e2
    ls.is_tri[:p] = is_tri
    ls.area[:p] = area
    ls.power[:p] = power
    ls.leaf_node[:p] = prim_leaf
    ls.node_left[:m] = l
    ls.node_right[:m] = r
    ls.node_min[:m] = nmin
    ls.node_max[:m] = nmax
    ls.node_power[:m] = npow
    ls.node_parent[:m] = par
    ls.num_nodes = m
    ls.leaf_prim[:m] = np.where(leaf_mask, r.astype(np.int64), -1)
    ls.prim_min[:p] = pmin
    ls.prim_max[:p] = pmax

    if ls.ancestors.shape[0] > 1:
        # A[a, q] = 1 iff a is on the root->leaf(q) path, a != root (node 0):
        # descent probability of prim q = prod of normalized importances over
        # its non-root path nodes — one matmul on device (wavefront.py).
        # Columns are PRIM indices so the NEE-pdf sweep can read pdf walk
        # probabilities with a static slice (no slot cap, every hit exact).
        anc = np.zeros(ls.ancestors.shape, np.float32)
        for q in range(p):
            a = int(prim_leaf[q])
            while a != 0:
                anc[a, q] = 1.0
                a = int(par[a]) if par[a] != SENTINEL else 0
        ls.ancestors = anc
    return ls


def build_from_grid(
    grid: np.ndarray,
    grid_origin,
    registry: BlockRegistry,
    max_prims: int,
    extra_tris: tuple = None,
) -> LightSet:
    """LightSet for a voxel grid (+ optional emissive entity triangles).

    extra_tris: (verts (T,3,3), power (T,)) triangles in world space.
    """
    p0, e1, e2, power, _, _ = extract_voxel_lights(
        grid, np.asarray(grid_origin), registry
    )
    is_tri = np.zeros(len(p0), bool)
    if extra_tris is not None and len(extra_tris[0]) > 0:
        tv, tp = extra_tris
        p0 = np.concatenate([p0, tv[:, 0].astype(np.float32)])
        e1 = np.concatenate([e1, (tv[:, 1] - tv[:, 0]).astype(np.float32)])
        e2 = np.concatenate([e2, (tv[:, 2] - tv[:, 0]).astype(np.float32)])
        power = np.concatenate([power, tp.astype(np.float32)])
        is_tri = np.concatenate([is_tri, np.ones(len(tv), bool)])
    return build_light_set(p0, e1, e2, power, is_tri, max_prims)

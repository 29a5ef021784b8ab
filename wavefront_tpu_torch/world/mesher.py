"""Voxel face mesher + hitbox extraction.

Reference: src/game_system/chunk.rs:112-292.  The DDA renderer needs no
triangle meshes (faces are evaluated implicitly per boundary crossing,
render/intersect.py), so unlike the reference this mesher is NOT in the hot
path — it exists for mesh export/visualization, for building light geometry
oracles, and as the explicit statement of the face rule: a face of block A
toward neighbor B exists iff A is not completely transparent and B is
translucent (chunk.rs:222-287).

gen_mesh returns SoA triangle arrays in the renderer's entity-mesh format
(verts (T,3,3), uv (T,3,2), tex (T,)), with the reference's exact per-face
vertex winding and uv assignment.  gen_hitbox returns the solid-voxel cuboid
list the reference feeds rapier (chunk.rs:112-147).

A copy of `wavefront_tpu.world.mesher` on the port's block tables.
"""

from __future__ import annotations

import numpy as np

from wavefront_tpu_torch.world.blocks import FACE_AXIS, FACE_SIGN, BlockRegistry

# per-face triangle corner offsets and uvs, transcribed from the mesher's
# vertex listing (reference chunk.rs:222-287); corners are (dx, dy, dz)
_FACE_TRIS = {
    0: [((0, 0, 1), (0, 1)), ((0, 1, 0), (1, 0)), ((0, 0, 0), (1, 1)),
        ((0, 1, 1), (0, 0)), ((0, 1, 0), (1, 0)), ((0, 0, 1), (0, 1))],
    1: [((1, 1, 0), (0, 0)), ((1, 0, 1), (1, 1)), ((1, 0, 0), (0, 1)),
        ((1, 1, 0), (0, 0)), ((1, 1, 1), (1, 0)), ((1, 0, 1), (1, 1))],
    2: [((0, 0, 0), (0, 0)), ((1, 0, 0), (1, 0)), ((0, 0, 1), (0, 1)),
        ((1, 0, 0), (1, 0)), ((1, 0, 1), (1, 1)), ((0, 0, 1), (0, 1))],
    3: [((0, 1, 1), (1, 1)), ((1, 1, 0), (0, 0)), ((0, 1, 0), (1, 0)),
        ((0, 1, 1), (1, 1)), ((1, 1, 1), (0, 1)), ((1, 1, 0), (0, 0))],
    4: [((0, 1, 0), (0, 0)), ((1, 0, 0), (1, 1)), ((0, 0, 0), (0, 1)),
        ((0, 1, 0), (0, 0)), ((1, 1, 0), (1, 0)), ((1, 0, 0), (1, 1))],
    5: [((0, 0, 1), (1, 1)), ((1, 0, 1), (0, 1)), ((0, 1, 1), (1, 0)),
        ((1, 0, 1), (0, 1)), ((1, 1, 1), (0, 0)), ((0, 1, 1), (1, 0))],
}


def visible_faces(grid: np.ndarray, registry: BlockRegistry, neighbors=None):
    """All existing faces as (voxel (F,3) i64, face (F,) i32, block (F,) i32).

    neighbors: optional dict face->adjacent grid of the same shape for
    cross-chunk culling (reference NeighboringChunkData, chunk.rs:149-156);
    absent neighbors read as air.
    """
    transl = registry.translucent
    transp = registry.transparent
    voxels, faces, blocks = [], [], []
    for face in range(6):
        ax, sg = int(FACE_AXIS[face]), int(FACE_SIGN[face])
        nb = np.full(grid.shape, registry.air, grid.dtype)
        if sg > 0:
            src = grid.take(range(1, grid.shape[ax]), axis=ax)
            idx = [slice(None)] * 3
            idx[ax] = slice(0, grid.shape[ax] - 1)
            nb[tuple(idx)] = src
            if neighbors and face in neighbors:
                edge = [slice(None)] * 3
                edge[ax] = -1
                first = [slice(None)] * 3
                first[ax] = 0
                nb[tuple(edge)] = neighbors[face][tuple(first)]
        else:
            src = grid.take(range(0, grid.shape[ax] - 1), axis=ax)
            idx = [slice(None)] * 3
            idx[ax] = slice(1, grid.shape[ax])
            nb[tuple(idx)] = src
            if neighbors and face in neighbors:
                edge = [slice(None)] * 3
                edge[ax] = 0
                last = [slice(None)] * 3
                last[ax] = -1
                nb[tuple(edge)] = neighbors[face][tuple(last)]
        exists = (~transp[grid]) & transl[nb]
        vx, vy, vz = np.where(exists)
        voxels.append(np.stack([vx, vy, vz], -1))
        faces.append(np.full(len(vx), face, np.int32))
        blocks.append(grid[vx, vy, vz].astype(np.int32))
    return (
        np.concatenate(voxels) if voxels else np.zeros((0, 3), np.int64),
        np.concatenate(faces),
        np.concatenate(blocks),
    )


def gen_mesh(grid: np.ndarray, registry: BlockRegistry, neighbors=None,
             origin=(0.0, 0.0, 0.0)):
    """Face-culled triangle mesh of a voxel grid (reference chunk.rs:158-292)."""
    voxels, faces, blocks = visible_faces(grid, registry, neighbors)
    f = len(faces)
    verts = np.zeros((f * 2, 3, 3), np.float32)
    uv = np.zeros((f * 2, 3, 2), np.float32)
    tex = np.zeros(f * 2, np.int32)
    origin = np.asarray(origin, np.float32)
    for face in range(6):
        sel = np.where(faces == face)[0]
        if len(sel) == 0:
            continue
        base = voxels[sel].astype(np.float32) + origin
        tris = _FACE_TRIS[face]
        for t in range(2):
            for c in range(3):
                off, cuv = tris[t * 3 + c]
                verts[sel * 2 + t, c] = base + np.asarray(off, np.float32)
                uv[sel * 2 + t, c] = cuv
        tex[sel * 2] = blocks[sel] * 6 + face
        tex[sel * 2 + 1] = blocks[sel] * 6 + face
    return verts, uv, tex


def gen_hitbox(grid: np.ndarray, registry: BlockRegistry):
    """Solid-voxel cuboid centers (reference gen_hitbox, chunk.rs:112-147):
    unit cubes centered at voxel+0.5 for every solid voxel; None if empty."""
    solid = registry.solid[grid]
    vx, vy, vz = np.where(solid)
    if len(vx) == 0:
        return None
    return np.stack([vx, vy, vz], -1).astype(np.float32) + 0.5

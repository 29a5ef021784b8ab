"""Test/utility meshes (reference src/utils.rs:88-180); the port's own copy
of `wavefront_tpu.world.meshes` (pure NumPy).

Returns SoA triangle arrays (verts (T,3,3), uv (T,3,2), tex (T,)) consumed
by VoxelScene.add_object.  Face order, winding and uv assignment match the
reference's `cuboid`, including the texture-slot convention t = off + face
with off = 6 (block index 1's textures — grass — utils.rs:104).
"""

from __future__ import annotations

import numpy as np


def cuboid(loc, dims, tex_offset: int = 6):
    """Axis-aligned cuboid centered at loc (reference utils.rs:88-176)."""
    loc = np.asarray(loc, np.float32)
    dims = np.asarray(dims, np.float32)
    f = loc - 0.5 * dims

    def corner(ix, iy, iz):
        return np.array(
            [f[0] + ix * dims[0], f[1] + iy * dims[1], f[2] + iz * dims[2]],
            np.float32,
        )

    v000, v100 = corner(0, 0, 0), corner(1, 0, 0)
    v001, v101 = corner(0, 0, 1), corner(1, 0, 1)
    v010, v110 = corner(0, 1, 0), corner(1, 1, 0)
    v011, v111 = corner(0, 1, 1), corner(1, 1, 1)

    # (face, triangles of (vertex, uv))
    faces = [
        # left
        [(v001, (0, 1)), (v010, (1, 0)), (v000, (1, 1)),
         (v011, (0, 0)), (v010, (1, 0)), (v001, (0, 1))],
        # right
        [(v110, (0, 0)), (v101, (1, 1)), (v100, (0, 1)),
         (v110, (0, 0)), (v111, (1, 0)), (v101, (1, 1))],
        # down
        [(v000, (0, 0)), (v100, (1, 0)), (v001, (0, 1)),
         (v100, (1, 0)), (v101, (1, 1)), (v001, (0, 1))],
        # up
        [(v011, (1, 1)), (v110, (0, 0)), (v010, (1, 0)),
         (v011, (1, 1)), (v111, (0, 1)), (v110, (0, 0))],
        # back
        [(v010, (0, 0)), (v100, (1, 1)), (v000, (0, 1)),
         (v010, (0, 0)), (v110, (1, 0)), (v100, (1, 1))],
        # front
        [(v001, (1, 1)), (v101, (0, 1)), (v011, (1, 0)),
         (v101, (0, 1)), (v111, (0, 0)), (v011, (1, 0))],
    ]

    verts, uvs, texs = [], [], []
    for face_idx, vlist in enumerate(faces):
        for tri in range(2):
            tri_v = vlist[tri * 3 : tri * 3 + 3]
            verts.append([p for p, _ in tri_v])
            uvs.append([uv for _, uv in tri_v])
            texs.append(tex_offset + face_idx)
    return (
        np.asarray(verts, np.float32),
        np.asarray(uvs, np.float32),
        np.asarray(texs, np.int32),
    )


def unitcube(tex_offset: int = 6):
    """Unit cube spanning [-0.5, 0.5]^3 about the origin shifted per the
    reference (utils.rs:175-177: centered at origin)."""
    return cuboid((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), tex_offset)



def mesh_aabb(verts: np.ndarray):
    """Half-extents AABB of a mesh (reference utils.rs:179-209)."""
    lo = verts.reshape(-1, 3).min(axis=0)
    hi = verts.reshape(-1, 3).max(axis=0)
    return lo, hi

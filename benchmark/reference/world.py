"""The reference's world: block table and atlas, terrain, camera, meshes.

Written from the upstream renderer's rules (the block table of
`block.rs:32-127`, the terrain of `chunk.rs:55-110`, the orbit camera of
`camera.rs:22-125`, the cuboid mesh of `utils.rs:88-177`) and from the
program's documented choices where it departs from upstream (its gradient
noise in place of OpenSimplex, a seeded permutation).  The terrain is
vectorized over a whole window with torch, in float64, so that a
416x96x416 window takes well under a second on the card.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass

import numpy as np
import torch

TEX_SIZE = 16
FACE_NAMES = ("left", "right", "down", "up", "back", "front")
# face -> (axis, sign of the outward normal): -x +x -y +y -z +z
FACE_AXIS = np.array([0, 0, 1, 1, 2, 2], np.int64)
FACE_SIGN = np.array([-1, 1, -1, 1, -1, 1], np.int64)


@dataclass
class Blocks:
    names: list
    atlas: np.ndarray        # (num_blocks*6, 3, 16, 16, 4) float32
    luminance: np.ndarray    # (num_blocks*6,) float32
    translucent: np.ndarray  # (num_blocks+1,) bool, air last
    transparent: np.ndarray  # (num_blocks+1,) bool

    @property
    def air(self) -> int:
        return len(self.names)

    def index(self, name: str) -> int:
        return self.air if name == "air" else self.names.index(name)


def _png(path: str) -> np.ndarray:
    from PIL import Image

    im = Image.open(path).convert("RGBA")
    if im.size != (TEX_SIZE, TEX_SIZE):
        im = im.resize((TEX_SIZE, TEX_SIZE), Image.NEAREST)
    return np.asarray(im, np.float32) / 255.0


def load_blocks(assets: str) -> Blocks:
    """blocks.json and its PNG textures: blocks in sorted name order, air
    the implicit last id, texture slot block*6 + face, luminance the mean
    of r+g+b of the emissivity texture in 0..765 units."""
    with open(os.path.join(assets, "blocks.json")) as f:
        spec = json.load(f)["blocks"]
    names = sorted(spec)
    n = len(names)
    atlas = np.zeros((n * 6, 3, TEX_SIZE, TEX_SIZE, 4), np.float32)
    translucent = np.zeros(n + 1, bool)
    transparent = np.zeros(n + 1, bool)
    for b, name in enumerate(names):
        translucent[b] = spec[name]["translucent"]
        for f, face in enumerate(FACE_NAMES):
            for k, kind in enumerate(("reflectivity", "emissivity",
                                      "metallicity")):
                atlas[b * 6 + f, k] = _png(
                    os.path.join(assets, spec[name][face][kind]))
    translucent[n] = transparent[n] = True
    luminance = (atlas[:, 1, :, :, :3].sum(-1).mean((1, 2)) * 255.0)
    return Blocks(names, atlas, luminance.astype(np.float32), translucent,
                  transparent)


_GRADS = torch.tensor(
    [[1, 1, 0], [-1, 1, 0], [1, -1, 0], [-1, -1, 0], [1, 0, 1], [-1, 0, 1],
     [1, 0, -1], [-1, 0, -1], [0, 1, 1], [0, -1, 1], [0, 1, -1],
     [0, -1, -1]], dtype=torch.float64)


def _noise(perm, x, y, z):
    """Seeded lattice gradient noise with a quintic fade at float64
    points (broadcastable tensors)."""
    xi, yi, zi = (torch.floor(c).to(torch.int64) for c in (x, y, z))
    xf, yf, zf = x - xi, y - yi, z - zi

    def fade(t):
        return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)

    u, v, w = fade(xf), fade(yf), fade(zf)
    grads = _GRADS.to(x.device)

    def corner(dx, dy, dz):
        gi = perm[perm[perm[(xi + dx) & 255] + ((yi + dy) & 255)]
                  + ((zi + dz) & 255)] % 12
        g = grads[gi]
        return (g[..., 0] * (xf - dx) + g[..., 1] * (yf - dy)) \
            + g[..., 2] * (zf - dz)

    def lerp(a, b, t):
        return a + t * (b - a)

    x00 = lerp(corner(0, 0, 0), corner(1, 0, 0), u)
    x10 = lerp(corner(0, 1, 0), corner(1, 1, 0), u)
    x01 = lerp(corner(0, 0, 1), corner(1, 0, 1), u)
    x11 = lerp(corner(0, 1, 1), corner(1, 1, 1), u)
    return lerp(lerp(x00, x10, v), lerp(x01, x11, v), w)


def terrain(blocks: Blocks, lo, shape, device, seed: int = 0,
            noise_scale: float = 20.0, threshold: float = 0.2,
            depth_gradient: float = 50000.0, central_lamp: bool = True,
            slab: int = 32) -> torch.Tensor:
    """The (X, Y, Z) uint8 block grid whose voxel [0, 0, 0] sits at world
    block `lo`: density = noise(w / scale) - wy / gradient; solid where
    above the threshold, stone under a solid voxel, else grass; every
    voxel with |wx|, |wy|, |wz| < 3 a lamp.  Built in x slabs."""
    rs = np.random.RandomState(np.uint32(seed ^ 0x9E3779B9))
    p = rs.permutation(256).astype(np.int64)
    perm = torch.as_tensor(np.concatenate([p, p]), device=device)
    X, Y, Z = shape
    air, grass = blocks.air, blocks.index("grass")
    stone, lamp = blocks.index("stone"), blocks.index("lamp")
    grid = torch.empty(shape, dtype=torch.uint8, device=device)
    f64 = dict(dtype=torch.float64, device=device)
    wy = torch.arange(lo[1], lo[1] + Y, **f64)[None, :, None]
    wz = torch.arange(lo[2], lo[2] + Z, **f64)[None, None, :]
    for x0 in range(0, X, slab):
        wx = torch.arange(lo[0] + x0, lo[0] + min(x0 + slab, X),
                          **f64)[:, None, None]

        def solid(yy):
            d = _noise(perm, wx / noise_scale, yy / noise_scale,
                       wz / noise_scale) - yy / depth_gradient
            return d > threshold

        here, above = solid(wy), solid(wy + 1.0)
        out = torch.full(here.shape, air, dtype=torch.uint8, device=device)
        out[here & above] = stone
        out[here & ~above] = grass
        if central_lamp:
            def near(c):
                return (c > -3.0) & (c < 3.0)
            out[(near(wx) & near(wy) & near(wz)).expand(out.shape)] = lamp
        grid[x0:x0 + out.shape[0]] = out
    return grid


@dataclass
class Basis:
    eye: np.ndarray
    front: np.ndarray
    right: np.ndarray
    up: np.ndarray


def orbit_basis(root, offset: float, yaw: float, pitch: float,
                root_yaw: float = 0.0) -> Basis:
    """The orbit camera's float32 basis: front from yaw and pitch, right
    = front x world-up with world-up (0, -1, 0), up = right x front, the
    root's yaw composed about +y, eye = root - offset * front."""
    def unit(v):
        return v / np.linalg.norm(v)

    worldup = np.array([0.0, -1.0, 0.0], np.float32)
    front = unit(np.array([math.cos(yaw) * math.cos(pitch), math.sin(pitch),
                           math.sin(yaw) * math.cos(pitch)], np.float32))
    right = unit(np.cross(front, worldup))
    up = unit(np.cross(right, front))
    if root_yaw != 0.0:
        c, s = math.cos(root_yaw), math.sin(root_yaw)
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        front, right, up = rot @ front, rot @ right, rot @ up
    eye = np.asarray(root, np.float32) - offset * front
    return Basis(eye.astype(np.float32), front, right, up)


def cube_mesh(center=(0.0, 0.0, 0.0), dims=(1.0, 1.0, 1.0),
              tex_offset: int = 6):
    """The upstream cuboid: 12 triangles (verts (12,3,3), uv (12,3,2),
    tex (12,)) in face order left right down up back front, texture slot
    tex_offset + face."""
    c = np.asarray(center, np.float32)
    dm = np.asarray(dims, np.float32)
    f = c - 0.5 * dm

    def v(ix, iy, iz):
        return np.array([f[0] + ix * dm[0], f[1] + iy * dm[1],
                         f[2] + iz * dm[2]], np.float32)

    v000, v100, v001, v101 = v(0, 0, 0), v(1, 0, 0), v(0, 0, 1), v(1, 0, 1)
    v010, v110, v011, v111 = v(0, 1, 0), v(1, 1, 0), v(0, 1, 1), v(1, 1, 1)
    faces = [
        [(v001, (0, 1)), (v010, (1, 0)), (v000, (1, 1)),
         (v011, (0, 0)), (v010, (1, 0)), (v001, (0, 1))],
        [(v110, (0, 0)), (v101, (1, 1)), (v100, (0, 1)),
         (v110, (0, 0)), (v111, (1, 0)), (v101, (1, 1))],
        [(v000, (0, 0)), (v100, (1, 0)), (v001, (0, 1)),
         (v100, (1, 0)), (v101, (1, 1)), (v001, (0, 1))],
        [(v011, (1, 1)), (v110, (0, 0)), (v010, (1, 0)),
         (v011, (1, 1)), (v111, (0, 1)), (v110, (0, 0))],
        [(v010, (0, 0)), (v100, (1, 1)), (v000, (0, 1)),
         (v010, (0, 0)), (v110, (1, 0)), (v100, (1, 1))],
        [(v001, (1, 1)), (v101, (0, 1)), (v011, (1, 0)),
         (v101, (0, 1)), (v111, (0, 0)), (v011, (1, 0))],
    ]
    verts, uvs, texs = [], [], []
    for fi, tris in enumerate(faces):
        for t in (tris[:3], tris[3:]):
            verts.append([p for p, _ in t])
            uvs.append([uv for _, uv in t])
            texs.append(tex_offset + fi)
    return (np.asarray(verts, np.float32), np.asarray(uvs, np.float32),
            np.asarray(texs, np.int64))


def place(verts: np.ndarray, transform) -> np.ndarray:
    """Object-space triangles under a (3, 4) [R|t] transform, float32."""
    m = np.asarray(transform, np.float32)
    return (verts @ m[:, :3].T + m[:, 3]).astype(np.float32)

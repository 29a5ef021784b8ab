"""Block/material registry and texture atlas.

Reference: src/game_system/block.rs.  `blocks.json` (same schema as the
reference's assets/blocks.json, block.rs:32-58) defines per-block, per-face
reflectivity/emissivity/metallicity textures; blocks are indexed in sorted
name order (the reference iterates a BTreeMap, block.rs:84) with an implicit
trailing "air" id (block.rs:107).  Texture index for (block, face) is
block*6 + face (block.rs:116-119); face order LEFT RIGHT DOWN UP BACK FRONT
(block.rs:10-17) maps to -x +x -y +y -z +z.

A copy of `wavefront_tpu.world.blocks`.  The atlas is a stacked array [T, 3, H, W, 4] float32 in [0,1]
(T texture slots x {reflectivity, emissivity, metallicity}); the bindless
`texture2D tex[]` descriptor array becomes a plain gather.  Per-texture
luminance (mean of r+g+b in 0..255 units over the emissivity texture,
reference utils.rs:223-235) drives emissive-face detection for the light BVH.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

# Face order (reference block.rs:10-17) and the axis/sign each face points to.
FACE_LEFT, FACE_RIGHT, FACE_DOWN, FACE_UP, FACE_BACK, FACE_FRONT = range(6)
FACE_NAMES = ["left", "right", "down", "up", "back", "front"]
# face -> (axis, sign of outward normal)
FACE_AXIS = np.array([0, 0, 1, 1, 2, 2], dtype=np.int32)
FACE_SIGN = np.array([-1, 1, -1, 1, -1, 1], dtype=np.int32)

TEX_SIZE = 16  # all reference textures are 16x16


def _load_png(path: str) -> np.ndarray:
    from PIL import Image

    im = Image.open(path).convert("RGBA")
    a = np.asarray(im, dtype=np.float32) / 255.0
    if a.shape[:2] != (TEX_SIZE, TEX_SIZE):
        from PIL import Image as _I

        im = Image.open(path).convert("RGBA").resize((TEX_SIZE, TEX_SIZE), _I.NEAREST)
        a = np.asarray(im, dtype=np.float32) / 255.0
    return a


@dataclass
class BlockRegistry:
    """Loaded block table + texture atlas.

    atlas:        (num_blocks*6, 3, H, W, 4) float32  [reflect, emit, metal]
    luminance:    (num_blocks*6,) float32   mean(r+g+b)*255 of emissivity
    solid:        (num_blocks+1,) bool      (air entry False)
    translucent:  (num_blocks+1,) bool      (air True: block.rs:125-127)
    transparent:  (num_blocks+1,) bool      completely_transparent (air only)
    luminescent:  (num_blocks+1,) bool
    """

    names: list
    atlas: np.ndarray
    luminance: np.ndarray
    solid: np.ndarray
    translucent: np.ndarray
    transparent: np.ndarray
    luminescent: np.ndarray

    @property
    def num_blocks(self) -> int:
        return len(self.names)

    @property
    def air(self) -> int:
        """The implicit trailing air id (reference block.rs:107)."""
        return self.num_blocks

    def block_idx(self, name: str) -> int:
        if name == "air":
            return self.air
        return self.names.index(name)

    def material_offset(self, block_idx: int, face: int) -> int:
        """Texture slot of (block, face) (reference block.rs:116-119)."""
        return block_idx * 6 + face

    @staticmethod
    def load(assets_path: str) -> "BlockRegistry":
        """Load blocks.json + PNG textures (reference block.rs:70-114)."""
        with open(os.path.join(assets_path, "blocks.json")) as f:
            spec = json.load(f)["blocks"]

        names = sorted(spec.keys())  # BTreeMap order (block.rs:84)
        n = len(names)
        atlas = np.zeros((n * 6, 3, TEX_SIZE, TEX_SIZE, 4), dtype=np.float32)
        solid = np.zeros(n + 1, dtype=bool)
        translucent = np.zeros(n + 1, dtype=bool)
        transparent = np.zeros(n + 1, dtype=bool)
        luminescent = np.zeros(n + 1, dtype=bool)

        for bi, name in enumerate(names):
            b = spec[name]
            solid[bi] = b["solid"]
            translucent[bi] = b["translucent"]
            luminescent[bi] = b["luminescent"]
            for fi, fname in enumerate(FACE_NAMES):
                tex = b[fname]
                for ki, kind in enumerate(
                    ("reflectivity", "emissivity", "metallicity")
                ):
                    atlas[bi * 6 + fi, ki] = _load_png(
                        os.path.join(assets_path, tex[kind])
                    )

        # air: completely transparent, hence translucent (block.rs:121-127)
        transparent[n] = True
        translucent[n] = True

        # emissive-texture luminance in 0..765 byte units (utils.rs:223-235)
        emis = atlas[:, 1, :, :, :3]  # (T, H, W, 3) in [0,1]
        luminance = emis.sum(axis=-1).mean(axis=(1, 2)) * 255.0

        return BlockRegistry(
            names=names,
            atlas=atlas,
            luminance=luminance.astype(np.float32),
            solid=solid,
            translucent=translucent,
            transparent=transparent,
            luminescent=luminescent,
        )

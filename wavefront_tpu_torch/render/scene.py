"""Scene state as tensors on one device (static scenes).

Counterpart of `wavefront_tpu.render.scene` for a scene that does not
change between frames: the dense uint8 voxel grid, its world origin, the
256-entry block tables, the packed texture atlas, the dense light set and
an empty entity pool.  Block edits, the streamed window and entities come
in later slices of the port.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import NamedTuple

import numpy as np
import torch

from wavefront_tpu_torch.render import lights as lights_mod
from wavefront_tpu_torch.render.wavefront import LightArrays
from wavefront_tpu_torch.world.blocks import BlockRegistry


class SceneArrays(NamedTuple):
    """Everything a frame reads, as tensors on one device."""

    grid: torch.Tensor          # (gx, gy, gz) uint8 block ids
    grid_origin: tuple          # 3 ints: world coords of grid[0,0,0]
    transparent: torch.Tensor   # (256,) bool
    translucent: torch.Tensor   # (256,) bool
    luminescent: torch.Tensor   # (256,) bool
    atlas_packed: torch.Tensor  # (T, 16, 16, 12) f32: reflect|emit|metal RGBA
    tri_verts: torch.Tensor     # (0, 3, 3) f32: the entity pool (empty)
    tri_uv: torch.Tensor        # (0, 3, 2) f32
    tri_tex: torch.Tensor       # (0,) int32
    tri_active: torch.Tensor    # (0,) bool
    lights: LightArrays


def light_arrays(ls, device) -> LightArrays:
    """A lights.LightSet (or any object/mapping with its fields, numpy
    leaves) as LightArrays on `device`."""
    def get(name):
        v = ls[name] if isinstance(ls, Mapping) else getattr(ls, name)
        return np.asarray(v)

    def f32(name):
        return torch.as_tensor(get(name).astype(np.float32), device=device)

    def i64(name):
        return torch.as_tensor(get(name).astype(np.int64), device=device)

    return LightArrays(
        p0=f32("p0"), e1=f32("e1"), e2=f32("e2"),
        is_tri=torch.as_tensor(get("is_tri").astype(bool), device=device),
        area=f32("area"), power=f32("power"), leaf_node=i64("leaf_node"),
        num_prims=int(get("num_prims")),
        node_left=i64("node_left"), node_right=i64("node_right"),
        node_min=f32("node_min"), node_max=f32("node_max"),
        node_power=f32("node_power"), node_parent=i64("node_parent"),
        ancestors=f32("ancestors"), leaf_prim=i64("leaf_prim"),
        prim_min=f32("prim_min"), prim_max=f32("prim_max"),
    )


def packed_atlas(atlas: np.ndarray) -> np.ndarray:
    """(T, 3, H, W, 4) atlas -> (T, H, W, 12): the three kinds' RGBA of a
    texel side by side, so one texel is one contiguous 48-byte row."""
    t, _, h, w, _ = atlas.shape
    return np.ascontiguousarray(atlas.transpose(0, 2, 3, 1, 4)).reshape(
        t, h, w, 12).astype(np.float32)


def scene_arrays_from_numpy(d, device="cuda") -> SceneArrays:
    """The port's SceneArrays from the JAX package's SceneArrays leaves.

    `d` is a mapping (or an object with attributes) holding the fields
    of `wavefront_tpu.render.scene.SceneArrays` as numpy arrays, with
    `lights` itself a mapping or object of the LightArrays fields.  Fields
    the port does not use (aux_grid, material_offset, atlas, winpack) are
    ignored.  Tests use it so that both packages render the same bytes."""
    def get(name):
        return d[name] if isinstance(d, Mapping) else getattr(d, name)

    def t(name, dtype=None):
        a = np.asarray(get(name))
        if dtype is not None:
            a = a.astype(dtype)
        return torch.as_tensor(a, device=device)

    return SceneArrays(
        grid=t("grid", np.uint8),
        grid_origin=tuple(int(v) for v in np.asarray(get("grid_origin"))),
        transparent=t("transparent", bool),
        translucent=t("translucent", bool),
        luminescent=t("luminescent", bool),
        atlas_packed=t("atlas_packed", np.float32),
        tri_verts=torch.zeros((0, 3, 3), dtype=torch.float32, device=device),
        tri_uv=torch.zeros((0, 3, 2), dtype=torch.float32, device=device),
        tri_tex=torch.zeros((0,), dtype=torch.int32, device=device),
        tri_active=torch.zeros((0,), dtype=torch.bool, device=device),
        lights=light_arrays(get("lights"), device),
    )


class VoxelScene:
    """Host-side static scene: a voxel window and its lights.

    `get_arrays()` builds the light set (lights.build_from_grid) and moves
    everything to `device` once; later calls return the same arrays."""

    def __init__(self, registry: BlockRegistry, grid: np.ndarray,
                 grid_origin=(0, 0, 0), max_light_prims: int = 1024,
                 device="cuda"):
        self.registry = registry
        self.max_light_prims = max_light_prims
        self.device = torch.device(device)
        self._grid = np.asarray(grid, np.uint8)
        self._grid_origin = tuple(int(v) for v in grid_origin)
        nb = registry.num_blocks
        # blocks beyond the registry (ids up to 255) behave like air
        self._transparent = np.ones(256, bool)
        self._translucent = np.ones(256, bool)
        self._luminescent = np.zeros(256, bool)
        self._transparent[: nb + 1] = registry.transparent
        self._translucent[: nb + 1] = registry.translucent
        self._luminescent[: nb + 1] = registry.luminescent
        self._arrays = None

    @property
    def grid(self) -> np.ndarray:
        return self._grid

    @property
    def grid_origin(self) -> tuple:
        return self._grid_origin

    def add_object(self, *args, **kwargs):
        """Dynamic entities (the reference's add_object) are not ported
        yet; the entity pool stays empty."""
        raise NotImplementedError("dynamic entities are not ported yet")

    def get_arrays(self) -> SceneArrays:
        if self._arrays is not None:
            return self._arrays
        light_set = lights_mod.build_from_grid(
            self._grid, np.asarray(self._grid_origin), self.registry,
            self.max_light_prims,
        )
        dev = self.device
        self._arrays = SceneArrays(
            grid=torch.as_tensor(self._grid, device=dev),
            grid_origin=self._grid_origin,
            transparent=torch.as_tensor(self._transparent, device=dev),
            translucent=torch.as_tensor(self._translucent, device=dev),
            luminescent=torch.as_tensor(self._luminescent, device=dev),
            atlas_packed=torch.as_tensor(
                packed_atlas(self.registry.atlas), device=dev),
            tri_verts=torch.zeros((0, 3, 3), dtype=torch.float32, device=dev),
            tri_uv=torch.zeros((0, 3, 2), dtype=torch.float32, device=dev),
            tri_tex=torch.zeros((0,), dtype=torch.int32, device=dev),
            tri_active=torch.zeros((0,), dtype=torch.bool, device=dev),
            lights=light_arrays(light_set, dev),
        )
        return self._arrays

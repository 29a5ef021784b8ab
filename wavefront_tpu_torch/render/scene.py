"""Scene state as tensors on one device.

Counterpart of `wavefront_tpu.render.scene`: the dense uint8 voxel grid,
its world origin, the 256-entry block tables, the packed texture atlas,
the light set (dense or sparse) and the fixed-capacity triangle pool of
the dynamic entities (reference scene.rs:150-232), and the tracer's aux
grid (class bits and empty-space distance, `intersect.make_aux_grid`).

The grid changes by block edits (`VoxelScene.set_block`) and by the
streamed window's recenter (`VoxelScene.update_grid`).  The scene keeps
the grid and the aux grid on the host as numpy, copied on every edit (a
background rebuild may hold the old ones), and mirrors them on the
device: an edit writes its voxel and the part of the aux grid it changed,
a recenter rolls the device grid and aux and writes the boxes it
refreshed (`recenter_boxes`, `shift_refresh_aux`).  Every change gives a
new SceneArrays, so a renderer's caches keyed on the arrays object never
serve a frame from before the change.  The JAX package's TPU window pack
(`winpack`) and its fixed-size edit box, which spares XLA a recompile,
have no counterpart here: the device writes take the exact boxes.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import NamedTuple

import numpy as np
import torch

from wavefront_tpu_torch.render import lights as lights_mod
from wavefront_tpu_torch.render.intersect import (
    MAX_SKIP,
    aux_box,
    make_aux_grid,
    refresh_aux_box,
    update_aux_region,
)
from wavefront_tpu_torch.render.wavefront import LightArrays
from wavefront_tpu_torch.world.blocks import BlockRegistry


class SceneArrays(NamedTuple):
    """Everything a frame reads, as tensors on one device."""

    grid: torch.Tensor          # (gx, gy, gz) uint8 block ids
    aux_grid: torch.Tensor      # (gx, gy, gz) uint8: class | distance << 2
    grid_origin: tuple          # 3 ints: world coords of grid[0,0,0]
    transparent: torch.Tensor   # (256,) bool
    translucent: torch.Tensor   # (256,) bool
    luminescent: torch.Tensor   # (256,) bool
    atlas_packed: torch.Tensor  # (T, 16, 16, 12) f32: reflect|emit|metal RGBA
    tri_verts: torch.Tensor     # (E, 3, 3) f32: the entity triangle pool
    tri_uv: torch.Tensor        # (E, 3, 2) f32
    tri_tex: torch.Tensor       # (E,) int32 texture slots
    tri_active: torch.Tensor    # (E,) bool
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
    `lights` itself a mapping or object of the LightArrays fields.  The
    int32 `aux_grid` is carried as uint8 (a value past 255 raises).
    Fields the port does not use (material_offset, atlas, winpack) are
    ignored.  Tests use it so that both packages render the same bytes."""
    def get(name):
        return d[name] if isinstance(d, Mapping) else getattr(d, name)

    def t(name, dtype=None):
        a = np.asarray(get(name))
        if dtype is not None:
            a = a.astype(dtype)
        return torch.as_tensor(a, device=device)

    aux = np.asarray(get("aux_grid"))
    if aux.size and (aux.min() < 0 or aux.max() > 255):
        raise ValueError("scene_arrays_from_numpy: aux_grid values outside "
                         "0..255 do not fit uint8")
    return SceneArrays(
        grid=t("grid", np.uint8),
        aux_grid=torch.as_tensor(aux.astype(np.uint8), device=device),
        grid_origin=tuple(int(v) for v in np.asarray(get("grid_origin"))),
        transparent=t("transparent", bool),
        translucent=t("translucent", bool),
        luminescent=t("luminescent", bool),
        atlas_packed=t("atlas_packed", np.float32),
        tri_verts=t("tri_verts", np.float32),
        tri_uv=t("tri_uv", np.float32),
        tri_tex=t("tri_tex", np.int32),
        tri_active=t("tri_active", bool),
        lights=light_arrays(get("lights"), device),
    )


def recenter_boxes(delta, shape, changed, new_origin):
    """Boxes of a recentered window whose aux grid must be recomputed, as
    (lo, hi) corners in the NEW window's coordinates.

    delta: the world shift in voxels (new origin - old origin); shape: the
    window's shape; changed: world (lo, hi) boxes whose content differs
    from the old window's beyond the shift (chunks that landed since);
    new_origin: the new window's world origin.  Returns the entered slabs,
    the MAX_SKIP-deep margins at the trailing edges (kept distances there
    must grow back to what a full build gives) and the changed boxes that
    no slab covers (the JAX package's `render.scene.recenter_boxes`)."""
    delta = np.asarray(delta)
    shape = np.asarray(shape)
    lo_n = np.maximum(-delta, 0)
    hi_n = shape - np.maximum(delta, 0)
    slabs = []
    covered_lo, covered_hi = lo_n.copy(), hi_n.copy()
    for ax in range(3):
        if delta[ax] > 0:
            s_lo, s_hi = covered_lo.copy(), covered_hi.copy()
            s_lo[ax] = hi_n[ax]
            s_hi[ax] = shape[ax]
            slabs.append((s_lo, s_hi))
            m_lo, m_hi = covered_lo.copy(), covered_hi.copy()
            m_lo[ax] = 0
            m_hi[ax] = min(MAX_SKIP, shape[ax])
            slabs.append((m_lo, m_hi))
        elif delta[ax] < 0:
            s_lo, s_hi = covered_lo.copy(), covered_hi.copy()
            s_lo[ax] = 0
            s_hi[ax] = lo_n[ax]
            slabs.append((s_lo, s_hi))
            m_lo, m_hi = covered_lo.copy(), covered_hi.copy()
            m_lo[ax] = max(shape[ax] - MAX_SKIP, 0)
            m_hi[ax] = shape[ax]
            slabs.append((m_lo, m_hi))
        covered_lo[ax] = 0
        covered_hi[ax] = shape[ax]

    entered = [(np.maximum(s_lo, 0), np.minimum(s_hi, shape))
               for s_lo, s_hi in slabs]
    for lo_w, hi_w in changed or ():
        s_lo = np.maximum(np.asarray(lo_w, np.int64) - new_origin, 0)
        s_hi = np.minimum(np.asarray(hi_w, np.int64) - new_origin, shape)
        if any(np.all(s_lo >= e_lo) and np.all(s_hi <= e_hi)
               for e_lo, e_hi in entered):
            continue
        slabs.append((s_lo, s_hi))
    return slabs


def shift_refresh_aux(old_aux, grid, transparent, translucent, delta,
                      changed, new_origin):
    """The aux grid of a recentered window, from the old window's: the
    kept part shifted, then every box of `recenter_boxes` recomputed
    exactly (`refresh_aux_box` over the box padded by MAX_SKIP).  Returns
    (aux, dirty): a new numpy aux grid and the padded boxes it rewrote,
    which are what the device copy must take after its roll.  Numpy only,
    so a background worker may run it (the JAX package's
    `render.scene.shift_refresh_aux`)."""
    delta = np.asarray(delta)
    shape = np.asarray(grid.shape)
    aux = np.empty_like(old_aux)
    lo_n = np.maximum(-delta, 0)
    hi_n = shape - np.maximum(delta, 0)
    lo_o = lo_n + delta
    hi_o = hi_n + delta
    aux[lo_n[0]:hi_n[0], lo_n[1]:hi_n[1], lo_n[2]:hi_n[2]] = \
        old_aux[lo_o[0]:hi_o[0], lo_o[1]:hi_o[1], lo_o[2]:hi_o[2]]
    dirty = []
    for s_lo, s_hi in recenter_boxes(delta, shape, changed, new_origin):
        if np.any(s_lo >= s_hi):
            continue
        r_lo = np.maximum(s_lo - MAX_SKIP, 0)
        r_hi = np.minimum(s_hi + MAX_SKIP, shape)
        aux = refresh_aux_box(grid, aux, transparent, translucent,
                              r_lo, r_hi, in_place=True)
        dirty.append((r_lo, r_hi))
    return aux, dirty


def window_aux(old_aux, grid, transparent, translucent, delta, changed,
               new_origin):
    """`shift_refresh_aux`, or, when its padded boxes would hold more
    voxels than the window (a first load, where every chunk lands at
    once: 98 boxes padded to 94^3 in a 160^3 window, 9 s of refresh
    against 0.1 s of build on the host), the aux grid built afresh
    (`make_aux_grid`, equal to the refresh) with the whole window as the
    one dirty box."""
    shape = np.asarray(grid.shape)
    volume = 0
    for s_lo, s_hi in recenter_boxes(delta, shape, changed, new_origin):
        if np.all(s_lo < s_hi):
            volume += int(np.prod(np.minimum(s_hi + MAX_SKIP, shape)
                                  - np.maximum(s_lo - MAX_SKIP, 0)))
    if volume >= int(np.prod(shape)):
        return (make_aux_grid(grid, transparent, translucent),
                [(np.zeros(3, np.int64), shape)])
    return shift_refresh_aux(old_aux, grid, transparent, translucent, delta,
                             changed, new_origin)


def _box(lo, hi) -> tuple:
    return tuple(slice(int(a), int(b)) for a, b in zip(lo, hi))


class VoxelScene:
    """Host-side scene: a voxel window, its lights and the dynamic
    entities (triangle meshes, at most `max_entity_tris` triangles).

    `get_arrays()` builds the light set (lights.build_from_grid, with the
    emissive entity triangles) and, once per grid, the tracer's aux grid,
    and moves everything to `device`; later calls return the same arrays
    until an entity is added or removed or the grid is replaced
    (`set_grid`).  Moving an entity replaces only the triangle pool (and
    the light set when that entity emits); a block edit (`set_block`) and
    a window recenter (`update_grid`) write only what they change on the
    device.  Each of these gives new arrays (a new SceneArrays)."""

    def __init__(self, registry: BlockRegistry, grid: np.ndarray,
                 grid_origin=(0, 0, 0), max_light_prims: int = 1024,
                 max_entity_tris: int = 64, device="cuda"):
        self.registry = registry
        self.max_light_prims = max_light_prims
        self.max_entity_tris = max_entity_tris
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
        # key -> (verts (T,3,3), uv (T,3,2), tex (T,), transform (3,3|4))
        self._entities: dict = {}
        self._arrays = None
        self._aux = None

    @property
    def grid(self) -> np.ndarray:
        return self._grid

    @property
    def grid_origin(self) -> tuple:
        return self._grid_origin

    # ------ terrain ------

    def set_grid(self, grid: np.ndarray, grid_origin) -> None:
        """Replace the whole voxel window: everything is built again at the
        next `get_arrays`."""
        self._grid = np.asarray(grid, np.uint8)
        self._grid_origin = tuple(int(v) for v in grid_origin)
        self._aux = None
        self._arrays = None

    def update_grid(self, grid: np.ndarray, grid_origin, changed=None,
                    precomputed=None) -> None:
        """Move the window to `grid` at `grid_origin`, reusing its overlap
        with the current one (the streamed window's recenter).

        changed: world (lo, hi) boxes whose content differs from the
        current window's beyond the shift (chunks that landed since the
        last update); they are refreshed like entered slabs.
        precomputed: the host work of this update done by a background
        worker (`world.chunk_manager`): a dict with "old_origin" and, when
        the worker could shift, "aux" and "dirty" (`shift_refresh_aux`).
        It is used only while "old_origin" is still the current origin.

        The host aux grid is shifted and refreshed over the entered slabs
        (`window_aux`); the device grid and aux are rolled by the
        shift and take the refreshed boxes, and the light set is built
        again.  A change of shape or a shift of a whole window or more
        falls back to `set_grid`; the same grid at the same origin changes
        nothing.  Every torch call of an update runs here, on the caller's
        thread."""
        grid = np.asarray(grid, np.uint8)
        new_origin = np.asarray(grid_origin, np.int64)
        same = (np.array_equal(new_origin, self._grid_origin)
                and np.array_equal(grid, self._grid))
        if self._aux is not None and same:
            return
        if self._aux is None or self._grid.shape != grid.shape or same:
            self.set_grid(grid, new_origin)
            return
        delta = new_origin - np.asarray(self._grid_origin, np.int64)
        if np.any(np.abs(delta) >= np.array(grid.shape)):
            self.set_grid(grid, new_origin)
            return

        if (precomputed is not None and "aux" in precomputed
                and np.array_equal(precomputed.get("old_origin"),
                                   self._grid_origin)):
            aux, dirty = precomputed["aux"], precomputed["dirty"]
        else:
            aux, dirty = window_aux(
                self._aux, grid, self._transparent, self._translucent,
                delta, changed, new_origin)
        self._grid = grid
        self._grid_origin = tuple(int(v) for v in new_origin)
        self._aux = aux
        if self._arrays is None:
            return
        shift = tuple(int(-d) for d in delta)
        dev_grid = torch.roll(self._arrays.grid, shift, (0, 1, 2))
        dev_aux = torch.roll(self._arrays.aux_grid, shift, (0, 1, 2))
        for r_lo, r_hi in dirty:
            box = _box(r_lo, r_hi)
            dev_grid[box] = self._upload(grid[box])
            dev_aux[box] = self._upload(aux[box])
        self._arrays = self._arrays._replace(
            grid=dev_grid, aux_grid=dev_aux, grid_origin=self._grid_origin)
        # emitters may have entered or left the window
        self._refresh_lights()

    def set_block(self, world_pos, block_id: int) -> None:
        """Set one voxel (world coordinates; outside the window nothing
        happens).  The host grid and aux are copied and edited
        (`update_aux_region`); on live arrays the device grid takes the
        voxel and the device aux the box that changed, and the light set
        is built again only when the old or new block, or a neighbour,
        emits."""
        p = np.asarray(world_pos, np.int64) - np.asarray(self._grid_origin)
        shape = np.array(self._grid.shape)
        if np.any(p < 0) or np.any(p >= shape):
            return
        old = int(self._grid[tuple(p)])
        self._grid = self._grid.copy()
        self._grid[tuple(p)] = block_id
        lum = self._luminescent
        lights_touched = bool(lum[old] or lum[block_id])
        for ax in range(3):
            for sgn in (-1, 1):
                q = p.copy()
                q[ax] += sgn
                if np.all(q >= 0) and np.all(q < shape):
                    lights_touched |= bool(lum[self._grid[tuple(q)]])
        if self._aux is None:
            self._arrays = None
            return
        self._aux = update_aux_region(self._grid, self._aux,
                                      self._transparent, self._translucent, p)
        if self._arrays is None:
            return
        grid = self._arrays.grid.clone()
        grid[tuple(int(v) for v in p)] = int(block_id)
        aux = self._arrays.aux_grid.clone()
        box = _box(*aux_box(p, shape))
        aux[box] = self._upload(self._aux[box])
        self._arrays = self._arrays._replace(grid=grid, aux_grid=aux)
        if lights_touched:
            self._refresh_lights()

    def get_block(self, world_pos) -> int:
        """The block at a world position; air outside the window."""
        p = np.asarray(world_pos, np.int64) - np.asarray(self._grid_origin)
        if np.any(p < 0) or np.any(p >= np.array(self._grid.shape)):
            return self.registry.air
        return int(self._grid[tuple(p)])

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array (or a box of one) as a new tensor on the device."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------ entities (reference scene.rs:150-232) ------

    def add_object(self, key, verts, uv, tex, transform=None) -> None:
        """Add a triangle mesh entity.

        verts: (T,3,3) object-space vertices; uv: (T,3,2); tex: (T,)
        texture slots; transform: optional (3,3) rotation or (3,4) [R|t]
        affine, applied when the pool is built."""
        self._entities[key] = (
            np.asarray(verts, np.float32),
            np.asarray(uv, np.float32),
            np.asarray(tex, np.int32),
            np.eye(4, dtype=np.float32)[:3] if transform is None
            else np.asarray(transform, np.float32),
        )
        self._arrays = None

    def update_object(self, key, transform) -> None:
        """Move an entity: only the triangle pool is uploaded again, and
        the light set is rebuilt when the moved entity emits.  The same
        transform again changes nothing and keeps the arrays (physics
        reports every body each step, a resting one too), so a held
        camera keeps the renderer's primary-hit cache."""
        v, u, t, m = self._entities[key]
        transform = np.asarray(transform, np.float32)
        if np.array_equal(transform, m):
            return
        self._entities[key] = (v, u, t, transform)
        if self._arrays is None:
            return
        verts, uv, tex, active = self._entity_pool()
        self._arrays = self._arrays._replace(
            **self._pool_tensors(verts, uv, tex, active))
        lum = self.registry.luminance
        if (lum[np.clip(t, 0, len(lum) - 1)] > 0).any():
            self._refresh_lights(verts, tex, active)

    def remove_object(self, key) -> None:
        if key in self._entities:
            del self._entities[key]
            self._arrays = None

    def _entity_pool(self):
        """World-space triangles of every entity, in key order, padded to
        the pool capacity: (verts, uv, tex, active)."""
        cap = self.max_entity_tris
        verts = np.zeros((cap, 3, 3), np.float32)
        uv = np.zeros((cap, 3, 2), np.float32)
        tex = np.zeros(cap, np.int32)
        active = np.zeros(cap, bool)
        k = 0
        for key in sorted(self._entities.keys(), key=str):
            v, u, t, m = self._entities[key]
            if m.shape[1] == 4:
                r, tr = m[:, :3], m[:, 3]
            else:
                r, tr = m, np.zeros(3, np.float32)
            n = len(v)
            if k + n > cap:
                raise ValueError(
                    f"entity triangle budget exceeded ({k + n} > {cap})")
            verts[k:k + n] = v @ r.T + tr
            uv[k:k + n] = u
            tex[k:k + n] = t
            active[k:k + n] = True
            k += n
        return verts, uv, tex, active

    def _emissive_entity_tris(self, verts, tex, active):
        """(triangles (T,3,3), power (T,)) of the pool's emissive
        triangles: texture luminance times area (scene.rs:563-571)."""
        lum = self.registry.luminance
        t = tex[active]
        v = verts[active]
        mask = lum[np.clip(t, 0, len(lum) - 1)] > 0
        if not mask.any():
            return np.zeros((0, 3, 3), np.float32), np.zeros(0, np.float32)
        tv = v[mask]
        area = 0.5 * np.linalg.norm(
            np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]), axis=-1)
        return tv, (lum[t[mask]] * area).astype(np.float32)

    def _pool_tensors(self, verts, uv, tex, active) -> dict:
        dev = self.device
        return dict(tri_verts=torch.as_tensor(verts, device=dev),
                    tri_uv=torch.as_tensor(uv, device=dev),
                    tri_tex=torch.as_tensor(tex, device=dev),
                    tri_active=torch.as_tensor(active, device=dev))

    def _light_arrays(self, verts, tex, active) -> LightArrays:
        light_set = lights_mod.build_from_grid(
            self._grid, np.asarray(self._grid_origin), self.registry,
            self.max_light_prims,
            extra_tris=self._emissive_entity_tris(verts, tex, active),
        )
        return light_arrays(light_set, self.device)

    def _refresh_lights(self, verts=None, tex=None, active=None) -> None:
        """Build the light set of live arrays again (the entity pool's
        arrays when given, else built here)."""
        if verts is None:
            verts, _, tex, active = self._entity_pool()
        self._arrays = self._arrays._replace(
            lights=self._light_arrays(verts, tex, active))

    def get_arrays(self) -> SceneArrays:
        if self._arrays is not None:
            return self._arrays
        verts, uv, tex, active = self._entity_pool()
        dev = self.device
        if self._aux is None:
            self._aux = make_aux_grid(self._grid, self._transparent,
                                      self._translucent)
        self._arrays = SceneArrays(
            grid=self._upload(self._grid),
            aux_grid=self._upload(self._aux),
            grid_origin=self._grid_origin,
            transparent=torch.as_tensor(self._transparent, device=dev),
            translucent=torch.as_tensor(self._translucent, device=dev),
            luminescent=torch.as_tensor(self._luminescent, device=dev),
            atlas_packed=torch.as_tensor(
                packed_atlas(self.registry.atlas), device=dev),
            **self._pool_tensors(verts, uv, tex, active),
            lights=self._light_arrays(verts, tex, active),
        )
        return self._arrays

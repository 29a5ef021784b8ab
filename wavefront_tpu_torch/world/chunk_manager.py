"""Chunk streaming manager.

Reference: src/game_system/chunk_manager.rs.  Keeps a load window of chunks
around the ego (load radius 6, evict radius 8, chunk_manager.rs:29-37),
generates chunk data asynchronously on a worker pool (the reference uses a
15-thread pool + mpsc events, chunk_manager.rs:53-56), and applies
WorldSetBlock edits.

The counterpart of `wavefront_tpu.world.chunk_manager`.  Instead of meshing
each chunk into a triangle entity with its own BLAS (chunk_manager.rs:
215-253), generated chunks are written into the scene's single dense voxel
window: the voxel tracer needs no meshing, so a chunk becomes renderable
the moment its block data lands in the device grid.  The device window is
a fixed per-axis (2*w+1)-chunk box recentered on the ego chunk (by default
the reference-scale load_radius in x,z with a shallow y), updated
incrementally on recenter (device roll + entered-slab uploads,
scene.update_grid).  Worker threads run numpy only (chunk generation, the
window's assembly and its aux shift); every torch call of a recenter runs
on the frame thread, when `update` adopts the rebuild.  The JAX package's
TPU window tables (its tracer's schedule) have no counterpart here.

What it does is counted (`utils/spans.py::count_world`): chunks asked of
the generator, chunks whose data arrived, chunks evicted, window rebuilds
applied to the scene and block edits applied.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Tuple

import numpy as np

from wavefront_tpu_torch.core.config import WorldSettings
from wavefront_tpu_torch.render.scene import VoxelScene, window_aux
from wavefront_tpu_torch.utils.spans import count_world
from wavefront_tpu_torch.world import chunk as chunk_mod
from wavefront_tpu_torch.world.blocks import BlockRegistry
from wavefront_tpu_torch.world.game_world import Manager, UpdateData, WorldSetBlock
from wavefront_tpu_torch.world.worldgen import WorldGenerator

_FACE_OFFSET = {
    0: (-1, 0, 0), 1: (1, 0, 0), 2: (0, -1, 0),
    3: (0, 1, 0), 4: (0, 0, -1), 5: (0, 0, 1),
}


class ChunkQuerier:
    """Read API over loaded chunks (reference chunk_manager.rs:446-472)."""

    def __init__(self, manager: "ChunkManager"):
        self._m = manager

    def get_block(self, global_coords) -> Optional[int]:
        return self._m.get_block(global_coords)

    def get_blocks(self, global_coords):
        return self._m.get_blocks(global_coords)

    def trace_to_solid(self, origin, direction, radius: float):
        return self._m.trace_to_solid(origin, direction, radius)


class ChunkManager(Manager):
    def __init__(
        self,
        settings: WorldSettings,
        registry: BlockRegistry,
        scene: VoxelScene,
        window_chunks=None,
        workers: int = 15,  # reference game_world.rs:166
        synchronous: bool = False,
        async_rebuild: Optional[bool] = None,
    ):
        self.settings = settings
        self.registry = registry
        self.scene = scene
        # device-window half-extent per axis, in chunks.  None derives the
        # reference-scale window from WorldSettings.load_radius
        # (chunk_manager.rs:29-37): load_radius x,z and a shallow y (the
        # worldgen is surface terrain; a full cubic radius-6 window would
        # be 13^3 chunks of mostly sky/stone for no image difference).
        if window_chunks is None:
            window_chunks = (settings.load_radius, 1, settings.load_radius)
        if isinstance(window_chunks, int):
            window_chunks = (window_chunks,) * 3
        self.window_chunks = tuple(int(w) for w in window_chunks)
        self.generator = WorldGenerator(settings, registry)
        self.chunks: Dict[Tuple[int, int, int], np.ndarray] = {}
        self.edited: set = set()  # chunks diverged from worldgen (persistence)
        self.center_chunk = (0, 0, 0)
        self.synchronous = synchronous
        self._pool = None if synchronous else ThreadPoolExecutor(max_workers=workers)
        self._pending: Dict[Tuple[int, int, int], object] = {}
        self._window_dirty = True
        self._landed: set = set()  # chunks whose data arrived since rebuild
        # async window rebuild (the reference's frame never blocks on
        # gen/mesh — worker threads + mpsc, chunk_manager.rs:202-253;
        # here the heavy host builds of a recenter, grid assembly + aux
        # shift/refresh, run on ONE background worker while
        # frames keep serving the stale window; block edits arriving
        # mid-flight are queued and replayed after adoption)
        # None = follow `synchronous` (tests flip it post-construction)
        self._async_rebuild_opt = async_rebuild
        self._rebuild_pool = None          # created on first submit
        self._rebuild_job = None           # in-flight future
        self._edits_in_flight: list = []   # (world_coords, block_id) queue
        self.querier = ChunkQuerier(self)

    @property
    def async_rebuild(self) -> bool:
        if self._async_rebuild_opt is not None:
            return self._async_rebuild_opt
        return not self.synchronous

    # ---- block access ----

    def get_block(self, global_coords) -> Optional[int]:
        g = np.asarray(global_coords, np.int64)
        c, b = chunk_mod.global_to_chunk_coords(g, self.settings.chunk_size)
        data = self.chunks.get(tuple(int(x) for x in c))
        if data is None:
            return None
        return int(data[tuple(b)])

    def get_blocks(self, global_coords) -> np.ndarray:
        """Vectorized get_block: (N,3) int coords -> (N,) int16 block ids,
        -1 where the chunk is not loaded.  One dict lookup per DISTINCT
        chunk instead of per voxel — the physics voxel probes
        (cast_down / AABB overlap) are per-entity-per-frame hot paths
        (reference physics_manager.rs:163-188)."""
        g = np.asarray(global_coords, np.int64).reshape(-1, 3)
        cs = self.settings.chunk_size
        ck = g // cs                                    # (N,3) chunk keys
        lc = g - ck * cs                                # (N,3) locals
        out = np.full(g.shape[0], -1, np.int16)
        # group rows by chunk key
        order = np.lexsort((ck[:, 2], ck[:, 1], ck[:, 0]))
        cko = ck[order]
        bounds = np.nonzero(np.any(np.diff(cko, axis=0) != 0, axis=1))[0]
        starts = np.concatenate([[0], bounds + 1])
        ends = np.concatenate([bounds + 1, [g.shape[0]]])
        for s, e in zip(starts, ends):
            key = tuple(int(x) for x in cko[s])
            data = self.chunks.get(key)
            if data is None:
                continue
            rows = order[s:e]
            l = lc[rows]
            out[rows] = data[l[:, 0], l[:, 1], l[:, 2]].astype(np.int16)
        return out

    def set_block(self, global_coords, block_id: int) -> None:
        """reference chunk_manager.rs:331-392 (sans remeshing)."""
        g = np.asarray(global_coords, np.int64)
        c, b = chunk_mod.global_to_chunk_coords(g, self.settings.chunk_size)
        key = tuple(int(x) for x in c)
        data = self.chunks.get(key)
        if data is None:
            return
        data = data.copy()
        data[tuple(b)] = block_id
        self.chunks[key] = data
        self.edited.add(key)
        count_world("block_edits")
        # mirror into the device window (incremental single-voxel store)
        self.scene.set_block(g, block_id)
        if self._rebuild_job is not None:
            # a background rebuild snapshotted the chunks BEFORE this edit;
            # queue it for replay after adoption (idempotent if the job
            # raced past the dict update)
            self._edits_in_flight.append(
                (tuple(int(x) for x in g), int(block_id))
            )

    # ---- CPU picking ray (reference chunk_manager.rs:394-443) ----

    def trace_to_solid(self, origin, direction, radius: float):
        """0.01-step ray march to the first solid block; returns
        (block_coords, entry_face) or None.

        The reference's march (chunk_manager.rs:394-443) steps `loc +=
        direction` until the block coordinates change, stops past
        `radius`, and looks up each new block.  Here the steps' positions
        are accumulated in blocks of a whole radius at once (`np.cumsum`
        adds one step at a time, as the loop does, so every position,
        distance and cell is the loop's, bit for bit), and only the cells
        the march enters are looked up: the ego's mouse pick runs it every
        step, ~1,000 steps when it meets nothing."""
        step = 0.01
        direction = np.asarray(direction, np.float64)
        direction = direction / np.linalg.norm(direction) * step
        origin = np.asarray(origin, np.float64)
        r2 = radius * radius
        loc = origin
        quant = chunk_mod.floor_coords(loc)
        # the reference's bound on the cells entered
        cells_left = int(radius / step) + 2
        block_steps = int(radius / step) + 8
        solid = self.registry.solid
        while True:
            locs = np.cumsum(np.concatenate(
                [loc[None], np.broadcast_to(direction, (block_steps, 3))]),
                axis=0)[1:]
            out = np.flatnonzero(((locs - origin) ** 2).sum(axis=1) > r2)
            floors = np.floor(locs).astype(np.int64)
            prev = np.concatenate([quant[None], floors[:-1]])
            entered = np.flatnonzero((floors != prev).any(axis=1))
            end = out[0] if out.size else block_steps
            for k in entered[entered < end]:
                if cells_left == 0:
                    return None
                cells_left -= 1
                quant = floors[k]
                block = self.get_block(quant)
                if block is None:
                    return None
                if block < len(solid) and solid[block]:
                    delta = quant - chunk_mod.floor_coords(locs[k]
                                                           - direction)
                    if delta[0] == -1:
                        face = 1  # entered through its RIGHT face
                    elif delta[0] == 1:
                        face = 0
                    elif delta[1] == -1:
                        face = 3
                    elif delta[1] == 1:
                        face = 2
                    elif delta[2] == -1:
                        face = 5
                    else:
                        face = 4
                    return tuple(int(x) for x in quant), face
            if out.size:
                return None
            loc, quant = locs[-1], floors[-1]

    # ---- streaming ----

    def _window_keys(self, center):
        wx, wy, wz = self.window_chunks
        cx, cy, cz = center
        return [
            (cx + dx, cy + dy, cz + dz)
            for dx in range(-wx, wx + 1)
            for dy in range(-wy, wy + 1)
            for dz in range(-wz, wz + 1)
        ]

    def _request_chunk(self, key) -> None:
        if key in self.chunks or key in self._pending:
            return
        count_world("chunks_requested")
        if self.synchronous:
            self.chunks[key] = self.generator.generate_chunk(key)
            self._window_dirty = True
            self._landed.add(key)
            count_world("chunks_adopted")
        else:
            self._pending[key] = self._pool.submit(self.generator.generate_chunk, key)

    def _drain_pending(self) -> None:
        done = [k for k, f in self._pending.items() if f.done()]
        for k in done:
            self.chunks[k] = self._pending.pop(k).result()
            self._window_dirty = True
            self._landed.add(k)
        count_world("chunks_adopted", len(done))

    def _evict(self) -> None:
        # edited chunks are kept (divergence from the reference, which drops
        # edits on eviction, chunk_manager.rs:175-181 — kept here so
        # checkpoint/resume and round-trips preserve player edits)
        r = self.settings.evict_radius
        cx, cy, cz = self.center_chunk
        for k in list(self.chunks.keys()):
            if k in self.edited:
                continue
            if max(abs(k[0] - cx), abs(k[1] - cy), abs(k[2] - cz)) > r:
                del self.chunks[k]
                count_world("chunks_evicted")

    def _assemble(self, chunks, center, landed):
        """Pure window assembly from a chunk-dict snapshot: (grid, origin,
        changed world boxes).  Runs on the frame thread (sync path) or the
        background rebuild worker (async path)."""
        cs = self.settings.chunk_size
        wx, wy, wz = self.window_chunks
        span = (2 * wx + 1, 2 * wy + 1, 2 * wz + 1)
        grid = np.full(
            (span[0] * cs, span[1] * cs, span[2] * cs),
            self.registry.air,
            np.uint8,
        )
        cx, cy, cz = center
        for (kx, ky, kz), data in chunks.items():
            ix, iy, iz = kx - cx + wx, ky - cy + wy, kz - cz + wz
            if 0 <= ix < span[0] and 0 <= iy < span[1] and 0 <= iz < span[2]:
                grid[
                    ix * cs : (ix + 1) * cs,
                    iy * cs : (iy + 1) * cs,
                    iz * cs : (iz + 1) * cs,
                ] = data
        origin = ((cx - wx) * cs, (cy - wy) * cs, (cz - wz) * cs)
        changed = [
            (
                np.array(k, np.int64) * cs,
                (np.array(k, np.int64) + 1) * cs,
            )
            for k in landed
        ]
        return grid, origin, changed

    def _rebuild_window(self) -> None:
        """Synchronous window rebuild (assemble + scene.update_grid).

        Incremental: the scene reuses the overlap with the previous window
        (device roll + slab uploads + local aux refresh) and recomputes
        only entered slabs and chunks whose data landed since the last
        rebuild (scene.update_grid) — the DDA analog of the reference
        re-meshing only changed chunks (chunk_manager.rs:165-315)."""
        grid, origin, changed = self._assemble(
            self.chunks, self.center_chunk, self._landed
        )
        self.scene.update_grid(grid, origin, changed=changed)
        self._landed.clear()
        self._window_dirty = False
        count_world("window_rebuilds")

    def _submit_rebuild(self) -> None:
        """Launch the heavy host builds of a window update on the rebuild
        worker; frames keep serving the stale window until adoption."""
        chunks = dict(self.chunks)          # chunk arrays are copy-on-edit
        center = self.center_chunk
        landed = set(self._landed)
        self._landed.clear()
        self._window_dirty = False
        scene = self.scene
        old_origin = np.array(scene.grid_origin)
        old_aux = scene._aux                # repaired by edit replay if torn
        old_shape = scene.grid.shape
        transparent = scene._transparent
        translucent = scene._translucent

        def job():
            grid, origin, changed = self._assemble(chunks, center, landed)
            pre = {"old_origin": old_origin}
            delta = np.asarray(origin, np.int64) - old_origin
            if (
                old_aux is not None
                and old_shape == grid.shape
                and np.all(np.abs(delta) < np.array(grid.shape))
            ):
                aux, dirty = window_aux(
                    old_aux, grid, transparent, translucent,
                    delta, changed, np.asarray(origin, np.int64),
                )
                pre["aux"] = aux
                pre["dirty"] = dirty
            return grid, origin, changed, pre

        if self._rebuild_pool is None:
            self._rebuild_pool = ThreadPoolExecutor(max_workers=1)
        self._rebuild_job = self._rebuild_pool.submit(job)

    def _adopt_rebuild(self) -> None:
        """Adopt a finished background rebuild, then replay edits that
        arrived while it was in flight (they were applied to the OLD
        window and would otherwise be clobbered by the snapshot)."""
        grid, origin, changed, pre = self._rebuild_job.result()
        self._rebuild_job = None
        self.scene.update_grid(grid, origin, changed=changed,
                               precomputed=pre)
        count_world("window_rebuilds")
        edits, self._edits_in_flight = self._edits_in_flight, []
        for g, bid in edits:
            self.scene.set_block(g, bid)

    def update(self, data: UpdateData) -> list:
        """reference chunk_manager.rs:504-546."""
        for ch in data.world_changes:
            if isinstance(ch, WorldSetBlock):
                self.set_block(ch.global_coords, ch.block_id)

        ego = data.entities.get(data.ego_entity_id)
        if ego is not None:
            pos = ego.isometry[:, 3]
            c, _ = chunk_mod.global_to_chunk_coords(
                chunk_mod.floor_coords(pos), self.settings.chunk_size
            )
            center = tuple(int(x) for x in c)
            if center != self.center_chunk:
                self.center_chunk = center
                self._window_dirty = True

        for key in self._window_keys(self.center_chunk):
            self._request_chunk(key)
        if not self.synchronous:
            self._drain_pending()
        self._evict()

        if self._rebuild_job is not None and self._rebuild_job.done():
            self._adopt_rebuild()
        if self._window_dirty:
            if self.async_rebuild:
                if self._rebuild_job is None:
                    self._submit_rebuild()
            else:
                self._rebuild_window()
        return []

    def flush_rebuild(self) -> None:
        """Block until any in-flight background rebuild is adopted (tests,
        synchronous ladder rows)."""
        if self._rebuild_job is not None:
            self._rebuild_job.result()
            self._adopt_rebuild()

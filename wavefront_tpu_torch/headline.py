"""The port's workloads: the headline frame, the general frame, the
streamed window and the golden config-1 scene.

`build_scene` and `headline_setup` build the same scene, camera pose,
preferences and settings as the JAX package's `bench.py` (the 5x1x5-chunk
worldgen scene, 1920x1080, 4 bounces, NEE on, compaction and the trace
audit on), from the port's own modules.  `general_setup` is that frame
with a sparse light set (a lattice of lamp voxels) and a cube entity, on
the general (non-fused) shade path.  `streamed_setup` is the game layer's
streamed window of `tools/bench_ladder.py` (configs 6-8), and
`lamps_setup` that window lit by a lamp on each chunk column (a sparse
light set, so every bounce shades on the general path).  `config1_grid`
and `config1_pose` are the golden-image scene and camera of the
reference's tests (tests/test_golden.py).
"""

from __future__ import annotations

import os

import numpy as np

from wavefront_tpu_torch.core.camera import SphericalCamera
from wavefront_tpu_torch.core.config import (
    RenderingPreferences,
    RenderSettings,
    WorldSettings,
)
from wavefront_tpu_torch.render.scene import VoxelScene
from wavefront_tpu_torch.world import chunk as chunk_mod
from wavefront_tpu_torch.world import meshes
from wavefront_tpu_torch.world.blocks import BlockRegistry
from wavefront_tpu_torch.world.worldgen import WorldGenerator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets")
# rays of a bounce of the headline frame
HEADLINE_RAYS = 1920 * 1080


def build_scene(registry: BlockRegistry, world: WorldSettings, span: int = 2):
    """(2*span+1)^2 x 1 chunks around the origin as one uint8 grid;
    returns (grid, world origin of grid[0,0,0])."""
    gen = WorldGenerator(world, registry)
    cs = world.chunk_size
    nx = nz = 2 * span + 1
    grid = np.zeros((nx * cs, cs, nz * cs), np.uint8)
    for cx in range(-span, span + 1):
        for cz in range(-span, span + 1):
            grid[(cx + span) * cs:(cx + span + 1) * cs, :,
                 (cz + span) * cs:(cz + span + 1) * cs] = \
                gen.generate_chunk((cx, 0, cz))
    return grid, (-span * cs, 0, -span * cs)


def lamp_lattice(grid: np.ndarray, registry: BlockRegistry) -> list:
    """Grid cells of the general frame's lamp lattice: for i, j = 0..9 the
    point x = 8 + 16 i + (5 j + i^2) mod 7 - 3,
          y = 4 + (i^3 + 7 j^2 + 5 i j + 3 j) mod 23,
          z = 8 + 16 j + (3 i + j^2) mod 7 - 3,
    kept when its cell and six neighbours are air, so that every lamp
    exposes six faces.  The polynomial offsets keep lamps from lining up:
    no line through two lamps of the headline grid passes within 0.9 of
    more than three lamp centres, so a ray crosses few light prims."""
    air = grid == registry.air
    cells = []
    for i in range(10):
        for j in range(10):
            x = 8 + 16 * i + (5 * j + i * i) % 7 - 3
            y = 4 + (i ** 3 + 7 * j * j + 5 * i * j + 3 * j) % 23
            z = 8 + 16 * j + (3 * i + j * j) % 7 - 3
            around = [(x, y, z), (x - 1, y, z), (x + 1, y, z), (x, y - 1, z),
                      (x, y + 1, z), (x, y, z - 1), (x, y, z + 1)]
            if all(air[c] for c in around):
                cells.append((x, y, z))
    return cells


def _frame_setup(registry, grid, origin, width, height, bounces, device,
                 settings_kw):
    """(scene, settings, camera basis, prefs) of the headline frame on
    `grid`: the headline's pose, preferences and settings."""
    scene = VoxelScene(registry, grid, origin, max_light_prims=1024,
                       device=device)
    settings_kw.setdefault("trace_audit", True)
    settings_kw.setdefault("compaction", True)
    settings = RenderSettings(width=width, height=height, num_bounces=bounces,
                              max_trace_steps=192, **settings_kw)
    # hover above the terrain looking down at the central lamp
    cam = SphericalCamera()
    cam.set_root_position([0.0, 24.0, 0.0])
    cam.offset = 26.0
    cam.yaw = 0.6
    cam.pitch = -0.55
    return scene, settings, cam.eye_front_right_up(), \
        RenderingPreferences(nee_type=1)


def headline_setup(width: int = 1920, height: int = 1080, bounces: int = 4,
                   device="cuda", **settings_kw):
    """The headline workload: (scene, settings, camera basis, prefs).

    Compaction and the trace audit default on, as in the reference; its
    TPU schedule settings are not set here because the port ignores them."""
    registry = BlockRegistry.load(ASSETS)
    grid, origin = build_scene(registry, WorldSettings())
    return _frame_setup(registry, grid, origin, width, height, bounces,
                        device, settings_kw)


# slots per ray of the sparse NEE pdf sweep on the general frame: no ray of
# the 1920x1080x4 frame crosses more light prims (aux["nee_overflow"] == 0)
GENERAL_MAX_NEE_HITS = 8


def add_ego_cube(scene: VoxelScene, basis) -> None:
    """Add the "ego" cube entity (12 triangles, grass textures), 2 units
    wide, 8 units along the camera's view axis, as the app adds its ego
    cube (an entity with a mesh and an isometry)."""
    center = np.asarray(basis.eye, np.float32) \
        + 8.0 * np.asarray(basis.front, np.float32)
    transform = np.concatenate(
        [2.0 * np.eye(3, dtype=np.float32), center[:, None]], axis=1)
    scene.add_object("ego", *meshes.unitcube(), transform=transform)


def general_setup(width: int = 1920, height: int = 1080, bounces: int = 4,
                  device="cuda", **settings_kw):
    """The general-path workload: (scene, settings, camera basis, prefs).

    The headline scene, pose and settings, plus the lamp lattice (a sparse
    light set: more than 256 prims), plus the ego cube in view of the
    camera, rendered by the general shade (shade_fused=False) with the
    texel kernel."""
    settings_kw.setdefault("shade_fused", False)
    settings_kw.setdefault("shade_texel_kernel", True)
    settings_kw.setdefault("max_nee_hits", GENERAL_MAX_NEE_HITS)
    registry = BlockRegistry.load(ASSETS)
    grid, origin = build_scene(registry, WorldSettings())
    for cell in lamp_lattice(grid, registry):
        grid[cell] = registry.block_idx("lamp")
    scene, settings, basis, prefs = _frame_setup(
        registry, grid, origin, width, height, bounces, device, settings_kw)
    add_ego_cube(scene, basis)
    lights = scene.get_arrays().lights
    if lights.dense:
        raise AssertionError(
            f"general_setup: {lights.num_prims} light prims make a dense "
            "light set; the lattice must yield more than 256")
    return scene, settings, basis, prefs


def streamed_setup(width: int = 1920, height: int = 1080, bounces: int = 4,
                   device="cuda", load_radius: int = 6):
    """The game layer's streamed window at the reference's scale (ladder
    configs 6-8): (scene, chunk manager, settings, camera basis, prefs).

    A ChunkManager at load radius 6 (13x3x13 chunks of 32^3: a
    416x96x416 window around chunk (0, 0, 0); `load_radius` r gives
    (2r+1)x3x(2r+1) chunks), its chunks generated
    synchronously and assembled once, the same pose and settings as
    `tools/bench_ladder.py::streamed_setup`, and NEE on.  The TPU schedule
    settings it sets are accepted and change nothing here."""
    from wavefront_tpu_torch.world.chunk_manager import ChunkManager

    registry = BlockRegistry.load(ASSETS)
    scene = VoxelScene(registry, np.zeros((1, 1, 1), np.uint8), (0, 0, 0),
                       max_light_prims=1024, device=device)
    cm = ChunkManager(WorldSettings(load_radius=load_radius,
                                    evict_radius=load_radius + 2),
                      registry, scene, window_chunks=None, synchronous=True)
    for key in cm._window_keys((0, 0, 0)):
        cm._request_chunk(key)
    cm._rebuild_window()
    settings = RenderSettings(
        width=width, height=height, num_bounces=bounces,
        max_trace_steps=192, trace_audit=True, compaction=True,
        trace_unroll=4, trace_tile=1024, trace_skip_stride=2,
        trace_phases=2, trace_phase_events=16, trace_phases_at=(1, 2, 3, 4))
    cam = SphericalCamera()
    cam.set_root_position([0.0, 14.0, 0.0])
    cam.offset = 26.0
    cam.yaw = 0.35
    cam.pitch = -0.55
    return scene, cm, settings, cam.eye_front_right_up(), \
        RenderingPreferences(nee_type=1)


def window_lamps(grid: np.ndarray, registry: BlockRegistry) -> list:
    """Grid cells of the lamps of a streamed window: one on each chunk
    column (i, j) of the grid (i, j = 0..12 in the radius-6 window), at
          x = 32 i + 16 + (5 j + i^2) mod 7 - 3,
          z = 32 j + 16 + (3 i + j^2) mod 7 - 3,
    one cell above the column's highest non-air cell: a lamp resting on
    the ground, as a player places one.  A lamp is kept where that cell
    lies below the window's top row.  The offsets keep lamps from lining
    up, so that a ray crosses few light prims."""
    cs = WorldSettings().chunk_size
    filled = grid != registry.air
    top = grid.shape[1] - 1
    cells = []
    for i in range(grid.shape[0] // cs):
        for j in range(grid.shape[2] // cs):
            x = cs * i + 16 + (5 * j + i * i) % 7 - 3
            z = cs * j + 16 + (3 * i + j * j) % 7 - 3
            ys = np.flatnonzero(filled[x, :, z])
            if ys.size and ys[-1] + 1 < top:
                cells.append((x, int(ys[-1]) + 1, z))
    return cells


def lamps_setup(width: int = 1920, height: int = 1080, bounces: int = 4,
                device="cuda", load_radius: int = 6):
    """The streamed window lit by player-placed lamps: `streamed_setup`'s
    (scene, chunk manager, settings, camera basis, prefs), with the cells
    of `window_lamps` set to lamp in the manager's chunks and in the
    scene, in one grid update.  Their light set is sparse (more than 256
    prims), so `use_fused` sends every bounce to the general shade."""
    scene, cm, settings, basis, prefs = streamed_setup(
        width, height, bounces, device, load_radius)
    registry = cm.registry
    lamp = registry.block_idx("lamp")
    grid = scene.grid.copy()
    for cell in window_lamps(grid, registry):
        grid[cell] = lamp
        # the chunks hold the lamp too, as a placed block is held
        key, b = chunk_mod.global_to_chunk_coords(
            np.add(scene.grid_origin, cell), cm.settings.chunk_size)
        key = tuple(int(c) for c in key)
        data = cm.chunks[key].copy()
        data[tuple(b)] = lamp
        cm.chunks[key] = data
        cm.edited.add(key)
    scene.set_grid(grid, scene.grid_origin)
    lights = scene.get_arrays().lights
    if lights.dense:
        raise AssertionError(
            f"lamps_setup: {lights.num_prims} light prims make a dense "
            "light set; the window's lamps must yield more than 256")
    return scene, cm, settings, basis, prefs


def config1_grid(registry: BlockRegistry, size: int = 16) -> np.ndarray:
    """The golden 16^3 scene: terrain slab, lamp, glass and a mirror."""
    grid = np.full((size, size, size), registry.air, np.uint8)
    grid[:, :4, :] = registry.block_idx("stone")
    grid[:, 4, :] = registry.block_idx("grass")
    grid[6:9, 5:8, 6:9] = registry.block_idx("lamp")
    grid[2, 5:7, 3] = registry.block_idx("mirror")
    grid[12, 5:7, 12] = registry.block_idx("glass")
    return grid


def config1_pose():
    """The golden camera basis."""
    cam = SphericalCamera()
    cam.set_root_position([8.0, 8.0, 8.0])
    cam.offset = 14.0
    cam.yaw = 0.7
    cam.pitch = -0.45
    return cam.eye_front_right_up()

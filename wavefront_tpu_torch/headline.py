"""The port's workloads: the headline frame and the golden config-1 scene.

`build_scene` and `headline_setup` build the same scene, camera pose,
preferences and settings as the JAX package's `bench.py` (the 5x1x5-chunk
worldgen scene, 1920x1080, 4 bounces, NEE on, compaction and the trace
audit on), from the port's own modules.  `config1_grid` and
`config1_pose` are the golden-image scene and camera of the reference's
tests (tests/test_golden.py).
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
from wavefront_tpu_torch.world.blocks import BlockRegistry
from wavefront_tpu_torch.world.worldgen import WorldGenerator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets")


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


def headline_setup(width: int = 1920, height: int = 1080, bounces: int = 4,
                   device="cuda", **settings_kw):
    """The headline workload: (scene, settings, camera basis, prefs).

    Compaction and the trace audit default on, as in the reference; its
    TPU schedule settings are not set here because the port ignores them."""
    registry = BlockRegistry.load(ASSETS)
    grid, origin = build_scene(registry, WorldSettings())
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

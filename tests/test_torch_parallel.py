"""The port's pixel-range renderer (`wavefront_tpu_torch.parallel.mesh`)
against its own single-device frames and the JAX package's mesh
(tests/test_sharding.py).

`DistributedRenderer` over `make_mesh(devices=["cpu"] * k)` renders k
contiguous pixel ranges, one after another, and assembles them; no ray's
arithmetic reads another ray, so for k = 1, 2, 3 (a count that does not
divide the pixels) and 8 its image equals `Renderer.render`'s bit for
bit, over tests/test_sharding.py's feature matrix (NEE 0/1/2, sort 0/1,
compaction on and off), a supersampled frame, jitter and an entity.  One
32x32 frame is held to the JAX `DistributedRenderer(make_mesh(8))` within
max |diff| 1e-3 and RMS 1e-5 (tests/test_torch_render.py).
"""

import os
import sys

import numpy as np
import pytest
import torch

import wavefront_tpu.parallel.mesh as jax_mesh
from wavefront_tpu.core.camera import SphericalCamera as JaxCamera
from wavefront_tpu.core.config import RenderingPreferences as JaxPrefs
from wavefront_tpu.core.config import RenderSettings as JaxSettings
from wavefront_tpu.render.scene import VoxelScene as JaxScene
from wavefront_tpu.world.blocks import BlockRegistry as JaxRegistry
from wavefront_tpu_torch.core.camera import SphericalCamera
from wavefront_tpu_torch.core.config import (
    RenderingPreferences,
    RenderSettings,
    WorldSettings,
)
from wavefront_tpu_torch.parallel.mesh import DistributedRenderer, make_mesh
from wavefront_tpu_torch.render.renderer import Renderer
from wavefront_tpu_torch.render.scene import VoxelScene
from wavefront_tpu_torch.world import meshes
from wavefront_tpu_torch.world.blocks import BlockRegistry
from wavefront_tpu_torch.world.game_world import translation
from wavefront_tpu_torch.world.worldgen import WorldGenerator

ASSETS = "assets"


def pose(camera_cls):
    cam = camera_cls()
    cam.set_root_position([8.0, 8.0, 8.0])
    cam.offset = 12.0
    cam.yaw = 0.7
    cam.pitch = -0.4
    return cam.eye_front_right_up()


@pytest.fixture(scope="module")
def setup():
    """tests/test_sharding.py's scene: one 16^3 worldgen chunk."""
    registry = BlockRegistry.load(ASSETS)
    grid = WorldGenerator(WorldSettings(chunk_size=16),
                          registry).generate_chunk((0, 0, 0))
    scene = VoxelScene(registry, grid, (0, 0, 0), max_light_prims=256,
                       device="cpu")
    return scene, pose(SphericalCamera), grid


def cpus(k):
    return make_mesh(devices=["cpu"] * k)


def single(settings, scene, basis, prefs, frame):
    return Renderer(settings, device="cpu").render(scene, basis, prefs,
                                                   frame_count=frame)


@pytest.mark.parametrize(
    "nee_type,sort_type,compaction",
    [(0, 0, False), (1, 0, False), (2, 0, False), (1, 1, False),
     (1, 0, True), (1, 1, True)])
def test_ranges_equal_the_single_frame(setup, nee_type, sort_type,
                                       compaction):
    scene, basis, _ = setup
    settings = RenderSettings(width=32, height=32, num_bounces=2,
                              max_trace_steps=48, compaction=compaction)
    prefs = RenderingPreferences(nee_type=nee_type, sort_type=sort_type)
    want = single(settings, scene, basis, prefs, 5)
    assert want.mean() > 1e-3
    for k in (1, 2, 3, 8):
        got = DistributedRenderer(settings, cpus(k)).render(
            scene, basis, prefs, frame_count=5)
        assert got.shape == (32, 32, 3)
        np.testing.assert_array_equal(got, want, err_msg=f"{k} ranges")


@pytest.mark.parametrize("kw", [dict(scale=2), dict(jitter=0.5),
                                dict(shade_fused=False)],
                         ids=["scale2", "jitter", "general"])
def test_ranges_equal_the_single_frame_variants(setup, kw):
    """A supersampled frame (ranges that split a box filter's rows), a
    jittered one (draws seeded by the global pixel id) and the general
    shade path, over 3 and 5 ranges of a 24x20 frame."""
    scene, basis, _ = setup
    settings = RenderSettings(width=24, height=20, num_bounces=2,
                              max_trace_steps=48, compaction=True, **kw)
    prefs = RenderingPreferences(nee_type=1)
    want = single(settings, scene, basis, prefs, 2)
    for k in (3, 5):
        got = DistributedRenderer(settings, cpus(k)).render(
            scene, basis, prefs, frame_count=2)
        np.testing.assert_array_equal(got, want, err_msg=f"{k} ranges")


def test_ranges_with_an_entity_and_an_edit(setup):
    """An entity's triangles ride the copied arrays; an edit gives new
    arrays, which the renderer copies again instead of reusing."""
    scene0, basis, grid = setup
    scene = VoxelScene(scene0.registry, grid.copy(), (0, 0, 0),
                       max_light_prims=256, device="cpu")
    verts, uv, tex = meshes.unitcube()
    scene.add_object("cube", verts, uv, tex,
                     transform=translation(8.0, 10.0, 8.0))
    settings = RenderSettings(width=20, height=20, num_bounces=2,
                              max_trace_steps=48)
    prefs = RenderingPreferences(nee_type=1)
    dr = DistributedRenderer(settings, cpus(3))
    for f in range(2):
        np.testing.assert_array_equal(
            dr.render(scene, basis, prefs, frame_count=f),
            single(settings, scene, basis, prefs, f))
    assert len(dr._held) == 1               # one copy for the one device
    held = dr._held[torch.device("cpu")]
    scene.set_block((8, 12, 8), scene0.registry.block_idx("stone"))
    np.testing.assert_array_equal(
        dr.render(scene, basis, prefs, frame_count=4),
        single(settings, scene, basis, prefs, 4))
    assert dr._held[torch.device("cpu")][0] is not held[0]


@pytest.mark.parametrize("accumulate", [False, True])
def test_render_batch_equals_singles(setup, accumulate):
    """k frames a call equal k single frames (their mean summed in frame
    order), with the primary cache on and off."""
    scene, basis, _ = setup
    prefs = RenderingPreferences(nee_type=1)
    for cache in (False, True):
        settings = RenderSettings(width=16, height=16, num_bounces=2,
                                  max_trace_steps=48, cache_primary=cache)
        dr = DistributedRenderer(settings, cpus(3))
        got = dr.render_batch(scene, basis, prefs, frame_count=5, k=3,
                              accumulate=accumulate)
        want = Renderer(settings, device="cpu").render_batch(
            scene, basis, prefs, frame_count=5, k=3, accumulate=accumulate)
        np.testing.assert_array_equal(got, want)
    singles = np.stack([dr.render(scene, basis, prefs, frame_count=5 + i)
                        for i in range(3)])
    if not accumulate:
        np.testing.assert_array_equal(got, singles)


def test_game_world_drives_the_ranges():
    """The game layer with a DistributedRenderer as its renderer
    (tests/test_sharding.py's game case): its frames equal the single
    renderer's."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_torch_utils import PORT, make_world

    registry = BlockRegistry.load(ASSETS)
    settings = RenderSettings(width=16, height=16, num_bounces=1,
                              max_trace_steps=16)
    world = make_world(PORT, registry)
    world.headless = False
    world.renderer = DistributedRenderer(settings, cpus(8))
    world.step()
    world.step()
    img = world.last_image
    assert img.shape == (16, 16, 3) and np.all(np.isfinite(img))
    want = Renderer(settings, device="cpu").render(
        world.scene, world.camera.eye_front_right_up(),
        world.camera.rendering_preferences(), frame_count=1)
    np.testing.assert_array_equal(img, want)


def test_ranges_match_the_jax_mesh(setup):
    """One 32x32 frame over 8 ranges against the JAX package's 8-device
    CPU mesh, within the render tolerance."""
    scene, basis, grid = setup
    kw = dict(width=32, height=32, num_bounces=2, max_trace_steps=48,
              compaction=True)
    got = DistributedRenderer(RenderSettings(**kw), cpus(8)).render(
        scene, basis, RenderingPreferences(nee_type=1, sort_type=1), 3)
    jscene = JaxScene(JaxRegistry.load(ASSETS), grid, (0, 0, 0),
                      max_light_prims=256)
    want = jax_mesh.DistributedRenderer(
        JaxSettings(**kw), jax_mesh.make_mesh(8)).render(
            jscene, pose(JaxCamera), JaxPrefs(nee_type=1, sort_type=1), 3)
    d = np.abs(got - want)
    assert got.mean() > 1e-3
    assert d.max() < 1e-3, d.max()
    assert np.sqrt((d ** 2).mean()) < 1e-5


def test_mesh_needs_the_card_unless_asked():
    settings = RenderSettings(width=8, height=8, num_bounces=1)
    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in make_mesh())
    else:
        with pytest.raises(RuntimeError):
            make_mesh()
        with pytest.raises(RuntimeError):
            DistributedRenderer(settings, ["cuda"])
    assert make_mesh(2, devices=["cpu"] * 4) == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError):
        make_mesh(devices=[])
    assert DistributedRenderer(settings, ["cpu"] * 100).ranges()[:2] == [
        (0, 0), (0, 1)]

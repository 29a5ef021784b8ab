"""The port's game layer against the JAX package's (reference
src/game_system/*).

Every scenario of tests/test_game.py runs through both GameWorlds (the
port's with device="cpu") on the same event script: the port keeps the
scenario's own assertions, and after the last step the two worlds hold
the same state exactly: the scene's grid and origin, the chunk dict, and
every entity's isometry, velocity, body type and groundedness (physics,
chunks and input are host numpy in both).  The two scenarios of
tests/test_game.py that bound wall-clock time hold this state equality
instead of a clock.  The one rendered step (16x16, on the reference-scale
window of tests/test_incremental.py) is held to the JAX Renderer's image
within max |diff| 1e-3 and RMS 1e-5 (tests/test_torch_render.py), and the
screenshot of the next step to the PNG of its image.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest

import wavefront_tpu.core.config as jax_config
import wavefront_tpu.world.game_world as jax_gw
import wavefront_tpu.world.meshes as jax_meshes
import wavefront_tpu.world.physics as jax_physics
import wavefront_tpu_torch.core.config as port_config
import wavefront_tpu_torch.world.game_world as port_gw
import wavefront_tpu_torch.world.meshes as port_meshes
import wavefront_tpu_torch.world.physics as port_physics
from wavefront_tpu.render.renderer import Renderer as JaxRenderer
from wavefront_tpu.world.blocks import BlockRegistry as JaxBlockRegistry
from wavefront_tpu_torch.render.screenshot import png_bytes, save_png, \
    to_srgb_bytes
from wavefront_tpu_torch.world.blocks import BlockRegistry
from wavefront_tpu_torch.world.input import Event

ASSETS = "assets"


@pytest.fixture(scope="module")
def sides():
    """The two packages' game layers, each with its own registry."""
    return {
        "port": SimpleNamespace(
            gw=port_gw, cfg=port_config, meshes=port_meshes,
            physics=port_physics, registry=BlockRegistry.load(ASSETS),
            kw={"device": "cpu"}),
        "jax": SimpleNamespace(
            gw=jax_gw, cfg=jax_config, meshes=jax_meshes,
            physics=jax_physics, registry=JaxBlockRegistry.load(ASSETS),
            kw={}),
    }


def cube_data(side, pos, controlled, kind="dynamic"):
    verts, uv, tex = side.meshes.unitcube()
    lo, hi = side.meshes.mesh_aabb(verts)
    return side.gw.EntityCreationData(
        mesh=side.gw.Mesh(verts, uv, tex),
        isometry=side.gw.translation(*pos),
        physics=side.gw.EntityPhysicsData(
            rigid_body_type=kind, half_extents=(hi - lo) / 2,
            linvel=np.zeros(3), angvel=np.zeros(3), controlled=controlled))


def make_world(side, **kw):
    """tests/test_game.py's world: air plus the central lamp cube
    (noise_threshold 10), a 3^3-chunk window of 16^3 chunks generated
    synchronously, and a dynamic ego cube at y = 30."""
    world = side.gw.GameWorld(
        side.registry,
        settings=side.cfg.RenderSettings(width=16, height=16, num_bounces=1,
                                         max_trace_steps=16),
        world_settings=side.cfg.WorldSettings(
            chunk_size=16, load_radius=1, evict_radius=2,
            noise_threshold=10.0),
        headless=True, window_chunks=1, **kw, **side.kw)
    world.managers[0].synchronous = True
    world.add_entity(0, cube_data(side, (0.0, 30.0, 0.0), True))
    return world


def assert_same_state(port, jax):
    np.testing.assert_array_equal(port.scene.grid, jax.scene.grid)
    assert tuple(int(v) for v in port.scene.grid_origin) == \
        tuple(int(v) for v in jax.scene.grid_origin)
    pc, jc = port.managers[0].chunks, jax.managers[0].chunks
    assert sorted(pc) == sorted(jc)
    for k in pc:
        np.testing.assert_array_equal(pc[k], jc[k])
    assert sorted(port.entities) == sorted(jax.entities)
    for k, pe in port.entities.items():
        je = jax.entities[k]
        np.testing.assert_array_equal(pe.isometry, je.isometry)
        assert (pe.physics_data is None) == (je.physics_data is None)
        if pe.physics_data is not None:
            pp, jp = pe.physics_data, je.physics_data
            np.testing.assert_array_equal(pp.linvel, jp.linvel)
            np.testing.assert_array_equal(pp.angvel, jp.angvel)
            assert pp.grounded == jp.grounded
            assert pp.rigid_body_type == jp.rigid_body_type
    for f in ("nee_type", "debug_view", "sort_type", "should_screenshot"):
        assert getattr(port.camera.rendering_preferences(), f) == \
            getattr(jax.camera.rendering_preferences(), f)


def both(sides, scenario):
    """Run `scenario(side)` on both packages; hold their final states equal
    and return the port's world (and what the scenario returned beside)."""
    port = scenario(sides["port"])
    jax = scenario(sides["jax"])
    assert_same_state(port[0], jax[0])
    assert port[1] == jax[1]
    return port


def test_step_streams_chunks(sides):
    def run(side):
        world = make_world(side)
        world.step()
        return world, None

    world, _ = both(sides, run)
    reg = sides["port"].registry
    assert len(world.managers[0].chunks) == 27
    assert world.scene.grid.shape == (48, 48, 48)
    assert world.scene.get_block((0, 0, 0)) == reg.block_idx("lamp")


def test_dynamic_ego_falls_and_lands(sides):
    def run(side):
        world = make_world(side)
        world.entities[0].isometry = side.gw.translation(0.5, 30.0, 0.5)
        for _ in range(250):
            world.step()
        return world, None

    world, _ = both(sides, run)
    ego = world.entities[0]
    assert 3.0 < ego.isometry[1, 3] < 4.5, ego.isometry
    assert ego.physics_data.grounded


def test_block_edit_roundtrip(sides):
    target = (5, 5, 5)

    def run(side):
        world = make_world(side)
        world.step()
        world.changes_since_last_step.append(side.gw.WorldSetBlock(
            np.array(target), side.registry.block_idx("stone")))
        world.step()
        return world, None

    world, _ = both(sides, run)
    stone = sides["port"].registry.block_idx("stone")
    assert world.chunk_querier.get_block(np.array(target)) == stone
    assert world.scene.get_block(target) == stone


def test_trace_to_solid_finds_lamp(sides):
    def run(side):
        world = make_world(side)
        world.step()
        return world, world.chunk_querier.trace_to_solid(
            np.array([8.0, 0.5, 0.5]), np.array([-1.0, 0.0, 0.0]), 10.0)

    world, hit = both(sides, run)
    assert hit == ((2, 0, 0), 1)


def test_ego_controls_kinematic_velocity(sides):
    def run(side):
        world = make_world(side)
        world.step()
        world.handle_window_event(Event("key_down", key="tab"))
        world.step()
        world.handle_window_event(Event("key_down", key="w"))
        world.step()
        world.step()
        return world, None

    world, _ = both(sides, run)
    ego = world.entities[0]
    assert ego.physics_data.rigid_body_type == "kinematic"
    assert ego.physics_data.linvel[0] == pytest.approx(10.0, abs=1e-4)


def test_render_toggles(sides):
    def run(side):
        world = make_world(side)
        world.step()
        seen = [world.camera.rendering_preferences().nee_type]
        for _ in range(3):
            world.handle_window_event(Event("key_down", key="n"))
            world.step()
            seen.append(world.camera.rendering_preferences().nee_type)
        world.handle_window_event(Event("key_down", key="b"))
        world.step()
        return world, seen

    world, seen = both(sides, run)
    assert seen == [0, 1, 2, 0]
    assert world.camera.rendering_preferences().debug_view == 1


def test_break_and_place_block(sides):
    def run(side):
        world = make_world(side)
        world.step()
        world.camera.yaw = np.pi
        world.camera.pitch = 0.0
        world.camera.offset = 1.0
        world.entities[0].isometry = side.gw.translation(8.0, 0.5, 0.5)
        world.managers[1].bodies[0].pos = np.array([8.0, 0.5, 0.5])
        world.managers[1].bodies[0].linvel[:] = 0.0
        world.step()
        # a clock that stands still: the first break is 1 s past the
        # last and the next within the 300 ms debounce, however slowly
        # the steps run
        ego = world.managers[2]
        ego._clock = lambda: 100.0
        ego.last_broke = 99.0
        world.handle_window_event(Event("mouse_move", x=8.0, y=8.0))
        world.handle_window_event(Event("mouse_down", button="left"))
        world.step()
        world.step()
        return world, None

    world, _ = both(sides, run)
    assert world.chunk_querier.get_block(np.array([2, 0, 0])) == \
        sides["port"].registry.air


def test_dynamic_bodies_stack(sides):
    def run(side):
        world = make_world(side)
        world.add_entity(1, cube_data(side, (0.0, 14.0, 0.0), False))
        for _ in range(400):
            world.step()
        return world, None

    world, _ = both(sides, run)
    ys = sorted(float(world.entities[e].isometry[1, 3]) for e in (0, 1))
    assert 3.0 < ys[0] < 4.6, ys
    assert ys[1] == pytest.approx(ys[0] + 1.0, abs=0.15), ys
    assert abs(world.entities[1].physics_data.linvel[1]) < 0.5


def test_dynamic_body_blocked_by_kinematic(sides):
    def run(side):
        world = make_world(side)
        world.step()
        pm = world.managers[1]
        pm.bodies[0].kind = "kinematic"
        pm.bodies[0].pos = np.array([8.5, 8.0, 8.5])
        pm.bodies[0].linvel = np.zeros(3)
        world.add_entity(1, cube_data(side, (8.5, 12.0, 8.5), False))
        for _ in range(300):
            world.step()
        return world, None

    world, _ = both(sides, run)
    assert world.entities[0].isometry[1, 3] == pytest.approx(8.0, abs=1e-6)
    assert world.entities[1].isometry[1, 3] == pytest.approx(9.0, abs=0.15)


def test_async_rebuild_recenter_and_edit_replay(sides):
    """A recenter adopted from the background rebuild, with an edit that
    lands while it is in flight replayed after adoption."""
    target = (5, 5, 5)

    def run(side):
        world = make_world(side)
        cm = world.managers[0]
        cm._async_rebuild_opt = True
        world.step()
        while cm._rebuild_job is not None or cm._window_dirty:
            cm.flush_rebuild()
            world.step()
        origin0 = tuple(int(v) for v in world.scene.grid_origin)
        world.entities[0].isometry = side.gw.translation(20.0, 1.0, 0.5)
        for b in world.managers[1].bodies.values():
            b.pos = np.array([20.0, 1.0, 0.5])
        world.step()
        assert cm._rebuild_job is not None
        assert tuple(int(v) for v in world.scene.grid_origin) == origin0
        # the job lands before the next step, which applies the edit to
        # the old window and then adopts: the same steps in every run, so
        # the two packages' bodies fall for as long
        cm._rebuild_job.result()
        world.changes_since_last_step.append(side.gw.WorldSetBlock(
            np.array(target), side.registry.block_idx("stone")))
        world.step()
        assert cm._rebuild_job is None and not cm._window_dirty
        while cm._rebuild_job is not None or cm._window_dirty:
            cm.flush_rebuild()
            world.step()
        return world, origin0

    world, origin0 = both(sides, run)
    cm = world.managers[0]
    stone = sides["port"].registry.block_idx("stone")
    assert tuple(int(v) for v in world.scene.grid_origin) != origin0
    assert world.scene.get_block(target) == stone
    assert world.chunk_querier.get_block(np.array(target)) == stone
    g, o, _ = cm._assemble(cm.chunks, cm.center_chunk, set())
    assert tuple(int(v) for v in world.scene.grid_origin) == tuple(o)
    np.testing.assert_array_equal(world.scene.grid, g)


def test_physics_broadphase_scales(sides):
    """Sweep-and-prune contacts of 400 spread bodies and of two overlapping
    ones: the same body positions and velocities as the JAX package's
    (tests/test_game.py bounds this one's time instead)."""
    def run(side, positions):
        pm = side.physics.PhysicsManager(chunk_querier=None,
                                         registry=side.registry)
        pm._aabb_overlaps_solid = lambda pos, half: False
        for i, p in enumerate(positions):
            pm.bodies[i] = side.physics._Body(
                kind="dynamic", pos=np.array(p), yaw=0.0,
                linvel=np.zeros(3), angvel_y=0.0, half=np.ones(3) * 0.5,
                mass=1.0, controlled=False)
        pm._resolve_entity_contacts(passes=4)
        return pm.bodies

    rs = np.random.RandomState(0)
    cases = [[(3.0 * i, 0.0, 0.0) for i in range(400)],
             [(0.0, 0.0, 0.0), (0.6, 0.0, 0.0)],
             list(map(tuple, rs.rand(60, 3) * 4.0))]
    for positions in cases:
        got = run(sides["port"], positions)
        want = run(sides["jax"], positions)
        for i in got:
            np.testing.assert_array_equal(got[i].pos, want[i].pos)
            np.testing.assert_array_equal(got[i].linvel, want[i].linvel)
            assert got[i].grounded == want[i].grounded
    got = run(sides["port"], cases[1])
    assert abs(got[1].pos[0] - got[0].pos[0]) >= 1.0 - 1e-9
    spread = run(sides["port"], cases[0])
    assert all(spread[i].pos[0] == 3.0 * i for i in spread)


def test_step_budget_streamed_scale(sides):
    """tests/test_game.py's streamed-scale world (load radius 3 of 16^3
    chunks, 48 dynamic bodies), 13 steps: the same state as the JAX
    package's (that test bounds the time of a step instead)."""
    def run(side):
        world = side.gw.GameWorld(
            side.registry,
            settings=side.cfg.RenderSettings(width=16, height=16,
                                             num_bounces=1,
                                             max_trace_steps=16),
            world_settings=side.cfg.WorldSettings(
                chunk_size=16, load_radius=3, evict_radius=4,
                noise_threshold=0.6),
            headless=True, window_chunks=3, **side.kw)
        world.managers[0].synchronous = True
        for i in range(48):
            pos = (float((i % 7) * 3 - 9), 24.0 + (i // 7) * 2.0,
                   float((i // 7) * 3 - 9))
            world.add_entity(i, cube_data(side, pos, i == 0))
        for _ in range(13):
            world.step()
        return world, None

    world, _ = both(sides, run)
    assert len(world.managers[0].chunks) == 7 ** 3
    assert world.scene.grid.shape == (112, 112, 112)


def test_reference_scale_window_from_load_radius(sides, tmp_path):
    """window_chunks=None derives the window from load_radius (13 x 3 x 13
    chunks at radius 6); one rendered 16x16 step on it, held to the JAX
    Renderer's image of the same step; the next step's screenshot is the
    PNG of its image."""
    def run(side, renderer=None, shots=None):
        world = side.gw.GameWorld(
            side.registry,
            settings=side.cfg.RenderSettings(width=16, height=16,
                                             num_bounces=1,
                                             max_trace_steps=48),
            world_settings=side.cfg.WorldSettings(chunk_size=8,
                                                  load_radius=6,
                                                  evict_radius=8),
            window_chunks=None, headless=False, renderer=renderer,
            screenshot_dir=shots, **side.kw)
        world.managers[0].synchronous = True
        world.step()
        return world, world.last_image

    jax_renderer = JaxRenderer(jax_config.RenderSettings(
        width=16, height=16, num_bounces=1, max_trace_steps=512,
        shade_fused=True, use_column_trace=False))
    shots = str(tmp_path / "shots")
    port = sides["port"]
    world, img = run(port, shots=shots)
    jworld, want = run(sides["jax"], renderer=jax_renderer, shots=shots)
    assert_same_state(world, jworld)
    assert world.scene.grid.shape == (13 * 8, 3 * 8, 13 * 8)
    assert len(world.managers[0].chunks) == 13 * 3 * 13
    assert img.shape == (16, 16, 3) and np.all(np.isfinite(img))
    d = np.abs(img - np.asarray(want))
    assert d.max() < 1e-3 and np.sqrt((d ** 2).mean()) < 1e-5, d.max()

    assert not os.path.exists(shots)
    # the ego controls ask for it on print_screen; this world has no ego
    world.camera.set_rendering_preferences(
        world.camera.rendering_preferences().replace(should_screenshot=True))
    world.step()
    assert not world.camera.rendering_preferences().should_screenshot
    with open(os.path.join(shots, "0.png"), "rb") as f:
        assert f.read() == png_bytes(to_srgb_bytes(world.last_image))


def test_png_round_trip(tmp_path):
    image = pytest.importorskip("PIL.Image")
    rs = np.random.RandomState(0)
    img = rs.rand(7, 13, 3).astype(np.float32) * 1.4 - 0.2
    path = str(tmp_path / "a" / "0.png")
    save_png(path, img)
    with image.open(path) as im:
        assert im.mode == "RGB" and im.size == (13, 7)
        np.testing.assert_array_equal(np.asarray(im), to_srgb_bytes(img))
    with pytest.raises(ValueError):
        png_bytes(np.zeros((2, 2, 4), np.uint8))

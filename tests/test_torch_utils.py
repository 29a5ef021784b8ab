"""The port's utilities against the JAX package's (tests/test_aux.py):
checkpoints (`utils/persistence.py`), the frame and stage timers and the
device trace (`utils/profiling.py`), and the validation layer
(`utils/validation.py`).

Checkpoints are held both ways: a save by either package loads in the
other with the same blocks, camera and entities, and the file holds the
same keys with the same dtypes.  The NaN checks are held on the port
alone (an op, a kernel's plain version, nothing outside the context) and
against the JAX layer on 16x16 frames of the fused path and of the
general path (its dense and its sparse NEE pdf sweep): none raises in
either package.
"""

import json
import os
import warnings

import numpy as np
import pytest
import torch

import wavefront_tpu.core.config as jax_config
import wavefront_tpu.render.lights as jax_lights
import wavefront_tpu.utils.persistence as jax_persistence
import wavefront_tpu.world.game_world as jax_gw
import wavefront_tpu.world.meshes as jax_meshes
import wavefront_tpu_torch.core.config as port_config
import wavefront_tpu_torch.render.lights as port_lights
import wavefront_tpu_torch.utils.persistence as port_persistence
import wavefront_tpu_torch.world.game_world as port_gw
import wavefront_tpu_torch.world.meshes as port_meshes
from wavefront_tpu.core.camera import SphericalCamera as JaxCamera
from wavefront_tpu.render.renderer import Renderer as JaxRenderer
from wavefront_tpu.render.scene import VoxelScene as JaxScene
from wavefront_tpu.render.scene import _light_arrays as jax_light_arrays
from wavefront_tpu.utils.validation import validation_layer as jax_validation
from wavefront_tpu.world.blocks import BlockRegistry as JaxRegistry
from wavefront_tpu_torch.core.camera import SphericalCamera
from wavefront_tpu_torch.core.config import RenderingPreferences
from wavefront_tpu_torch.kernels.texel import texel_fetch
from wavefront_tpu_torch.kernels.window_trace import window_trace
from wavefront_tpu_torch.render.renderer import Renderer
from wavefront_tpu_torch.render.scene import VoxelScene
from wavefront_tpu_torch.render.scene import light_arrays as port_light_arrays
from wavefront_tpu_torch.utils.profiling import (
    WARMUP_SPAN,
    FrameTimer,
    StageTimer,
    device_trace,
)
from wavefront_tpu_torch.utils.validation import check_image, validation_layer
from wavefront_tpu_torch.world.blocks import BlockRegistry

ASSETS = "assets"
PORT = dict(gw=port_gw, cfg=port_config, meshes=port_meshes,
            persistence=port_persistence, kw={"device": "cpu"})
JAX = dict(gw=jax_gw, cfg=jax_config, meshes=jax_meshes,
           persistence=jax_persistence, kw={})


@pytest.fixture(scope="module")
def regs():
    return {"port": BlockRegistry.load(ASSETS),
            "jax": JaxRegistry.load(ASSETS)}


def make_world(side, registry):
    """tests/test_game.py's world (air and the central lamp cube, a 3^3
    window of 16^3 chunks generated synchronously) with a dynamic ego
    cube at y = 30 and a kinematic cube beside it."""
    gw, cfg = side["gw"], side["cfg"]
    world = gw.GameWorld(
        registry,
        settings=cfg.RenderSettings(width=16, height=16, num_bounces=1,
                                    max_trace_steps=16),
        world_settings=cfg.WorldSettings(chunk_size=16, load_radius=1,
                                         evict_radius=2, noise_threshold=10.0),
        headless=True, window_chunks=1, **side["kw"])
    world.managers[0].synchronous = True
    verts, uv, tex = side["meshes"].unitcube()
    lo, hi = side["meshes"].mesh_aabb(verts)
    for eid, pos, kind in ((0, (0.0, 30.0, 0.0), "dynamic"),
                           (4, (3.0, 20.0, 1.0), "kinematic")):
        world.add_entity(eid, gw.EntityCreationData(
            mesh=gw.Mesh(verts, uv, tex), isometry=gw.translation(*pos),
            physics=gw.EntityPhysicsData(
                rigid_body_type=kind, half_extents=(hi - lo) / 2,
                linvel=np.zeros(3), angvel=np.zeros(3),
                controlled=eid == 0)))
    return world


def edited_save(side, registry, path):
    """A world stepped, edited at (5, 5, 5), turned and saved."""
    world = make_world(side, registry)
    world.step()
    stone = registry.block_idx("stone")
    world.changes_since_last_step.append(
        side["gw"].WorldSetBlock(np.array([5, 5, 5]), stone))
    world.step()
    world.camera.yaw = 1.23
    side["persistence"].save_world(world, path)
    return world


def assert_restored(world, saved, registry):
    """`world`, loaded from `saved`'s file and stepped once, holds its
    edit, camera and entities."""
    stone = registry.block_idx("stone")
    assert world.chunk_querier.get_block(np.array([5, 5, 5])) == stone
    assert world.scene.get_block((5, 5, 5)) == stone
    assert world.camera.yaw == pytest.approx(1.23)
    assert world.frame_count == saved.frame_count + 1
    assert sorted(world.entities) == sorted(saved.entities) == [0, 4]
    for eid, ent in saved.entities.items():
        got = world.entities[eid]
        np.testing.assert_array_equal(got.mesh.verts, ent.mesh.verts)
        assert got.physics_data.rigid_body_type == \
            ent.physics_data.rigid_body_type
    np.testing.assert_allclose(world.entities[4].isometry,
                               saved.entities[4].isometry)


@pytest.mark.parametrize("save,load", [("port", "port"), ("port", "jax"),
                                       ("jax", "port")])
def test_checkpoint_round_trip(tmp_path, regs, save, load):
    sides = {"port": PORT, "jax": JAX}
    path = str(tmp_path / "save.npz")
    saved = edited_save(sides[save], regs[save], path)
    world = make_world(sides[load], regs[load])
    sides[load]["persistence"].load_world(world, path)
    assert world.managers[0]._window_dirty
    world.step()
    assert_restored(world, saved, regs[load])


def test_checkpoint_files_match(tmp_path, regs):
    """The two packages write the same keys, dtypes, arrays and metadata."""
    files = {}
    for name, side in (("port", PORT), ("jax", JAX)):
        path = str(tmp_path / f"{name}.npz")
        edited_save(side, regs[name], path)
        files[name] = np.load(path)
    port, jax = files["port"], files["jax"]
    assert sorted(port.files) == sorted(jax.files)
    assert "chunk_0_0_0" in port.files and "mesh_4_verts" in port.files
    for key in port.files:
        assert port[key].dtype == jax[key].dtype, key
        if key != "__meta__":
            np.testing.assert_array_equal(port[key], jax[key], err_msg=key)
    meta = [json.loads(bytes(f["__meta__"]).decode()) for f in (port, jax)]
    assert meta[0] == meta[1]


def test_edited_chunks_survive_eviction(regs):
    world = make_world(PORT, regs["port"])
    world.step()
    cm = world.managers[0]
    stone = regs["port"].block_idx("stone")
    cm.set_block(np.array([5, 5, 5]), stone)
    cm.center_chunk = (50, 0, 0)
    cm._evict()
    assert (0, 0, 0) in cm.chunks and (1, 1, 1) not in cm.chunks
    assert cm.chunks[(0, 0, 0)][5, 5, 5] == stone


def test_frame_and_stage_timers():
    t = FrameTimer(rays_per_frame=1000)
    assert t.stats is None
    for _ in range(3):
        with t.frame():
            pass
    s = t.stats
    assert s.frame_ms >= 0 and s.fps > 0 and s.mrays_per_sec > 0
    assert t.maybe_report(interval=0.0) == s
    st = StageTimer()
    for _ in range(2):
        with st.stage("gen"):
            pass
    assert set(st.summary()) == {"gen"} and st.counts["gen"] == 2


def test_device_trace_writes_a_trace(tmp_path):
    with device_trace(str(tmp_path)) as d:
        torch.ones(64).mul(3.0).sum()
    assert d == str(tmp_path)
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::mul") for e in events)


@pytest.mark.parametrize("recorded", [2, 3])
def test_device_trace_warns_on_lost_kernel_records(tmp_path, monkeypatch,
                                                   recorded):
    """`device_trace` holds the K1-K3 launches its wrappers counted in the
    window against the kernel records of the trace it writes, outside the
    warm-up span.  A fake profiler writes the trace: a K1 record launched
    inside the warm-up span, then `recorded` of the region's three K1
    records.  One lost record makes it warn with both counts; a complete
    trace, nothing."""
    def launch(corr, ts):
        return {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
                "dur": 1, "args": {"correlation": corr}}

    def kernel(corr, ts):
        return {"cat": "kernel", "name": "trace_kernel(Grid, int)",
                "ts": ts, "dur": 1, "args": {"correlation": corr}}

    class FakeProfile:
        def __init__(self, activities):
            pass

        def start(self):
            pass

        def stop(self):
            pass

        def export_chrome_trace(self, path):
            events = [{"cat": "user_annotation", "name": WARMUP_SPAN,
                       "ts": 0, "dur": 10}, launch(1, 5), kernel(1, 6)]
            events += [launch(c, 10 * c) for c in (2, 3, 4)]
            events += [kernel(c, 10 * c + 5) for c in (2, 3, 4)[:recorded]]
            with open(path, "w") as f:
                json.dump({"traceEvents": events}, f)

    monkeypatch.setattr(torch.profiler, "profile", FakeProfile)
    monkeypatch.setattr(window_trace, "launches", 0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with device_trace(str(tmp_path)):
            window_trace.launches += 3      # as three launches on a card
    lost = [w for w in caught if "device_trace" in str(w.message)]
    if recorded == 3:
        assert lost == []
    else:
        assert len(lost) == 1 and lost[0].category is RuntimeWarning
        assert "'trace_kernel': {'launched': 3, 'recorded': 2}" in str(
            lost[0].message)
    assert os.path.exists(tmp_path / "trace.json")


def test_check_image():
    check_image(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(FloatingPointError):
        check_image(np.full((2, 2, 3), np.nan, np.float32))
    with pytest.raises(ValueError):
        check_image(np.zeros((2, 2), np.float32))


def test_validation_layer_raises_inside_only():
    zero = torch.zeros(3)
    with pytest.raises(FloatingPointError, match="aten.div"):
        with validation_layer():
            zero / zero
    assert torch.isnan(zero / zero).all()             # off outside
    with validation_layer(nan_checks=False, interpret=True):
        assert torch.isnan(zero / zero).all()
        assert float(torch.add(torch.tensor(1.0), 2.0)) == 3.0
    with validation_layer():
        torch.empty(1024)                             # uninitialized: unchecked
        torch.ones(3) / 2.0


def test_validation_layer_names_a_kernel():
    """A NaN texel read by the texel kernel's plain version raises as the
    kernel (its ops are one op to the layer, as the kernel is on the
    card); a clean read does not."""
    rs = np.random.RandomState(0)
    atlas = torch.from_numpy(rs.rand(4, 16, 16, 12).astype(np.float32))
    atlas[1, 2, 3, 0] = float("nan")
    tex = torch.tensor([1, 0], dtype=torch.int32)
    u = torch.tensor([3.5 / 16, 0.1])
    v = torch.tensor([2.5 / 16, 0.1])
    with pytest.raises(FloatingPointError, match="texel_fetch"):
        with validation_layer():
            texel_fetch(atlas, tex, u, v, channels=(0, 1))
    with validation_layer():
        texel_fetch(atlas, tex, u, v, channels=(4, 5))
    assert torch.isnan(texel_fetch(atlas, tex, u, v, channels=(0,))).any()


def frame_scene(reg, scene_cls, **kw):
    grid = np.full((16, 16, 16), reg.air, np.uint8)
    grid[:, :4, :] = reg.block_idx("stone")
    grid[:, 4, :] = reg.block_idx("grass")
    grid[6:9, 5:8, 6:9] = reg.block_idx("lamp")
    grid[2, 5:7, 3] = reg.block_idx("mirror")
    return scene_cls(reg, grid, (0, 0, 0), max_light_prims=256, **kw)


def pose(camera_cls):
    cam = camera_cls()
    cam.set_root_position([8.0, 8.0, 8.0])
    cam.offset = 14.0
    cam.yaw = 0.7
    cam.pitch = -0.45
    return cam.eye_front_right_up()


def outcome(run, layer):
    try:
        with layer():
            run()
    except FloatingPointError as e:
        return f"raises: {e}"
    return "passes"


def test_nan_checks_frame_outcome_matches_jax(regs):
    """A 16x16 frame (2 bounces, NEE, compaction, the fused shade) under
    the NaN checks passes in both packages."""
    kw = dict(width=16, height=16, num_bounces=2, max_trace_steps=48,
              compaction=True)
    port = outcome(lambda: Renderer(
        port_config.RenderSettings(**kw), device="cpu").render(
            frame_scene(regs["port"], VoxelScene, device="cpu"),
            pose(SphericalCamera), RenderingPreferences(nee_type=1), 3),
        validation_layer)
    jax = outcome(lambda: JaxRenderer(jax_config.RenderSettings(**kw)).render(
        frame_scene(regs["jax"], JaxScene), pose(JaxCamera),
        jax_config.RenderingPreferences(nee_type=1), 3), jax_validation)
    assert port == jax == "passes"


def sparse(arrays, light_arrays, build, extract, reg, grid, **kw):
    """`arrays` with its light set rebuilt as a sparse one (dense_threshold
    forced low), as tests/test_torch_render.py builds it."""
    p0, e1, e2, power = extract(grid, np.zeros(3), reg)[:4]
    ls = build(p0, e1, e2, power, np.zeros(len(p0), bool), 256,
               dense_threshold=8)
    out = arrays._replace(lights=light_arrays(ls, **kw))
    assert not out.lights.dense
    return out


@pytest.mark.parametrize("lights", ["dense", "sparse"])
def test_nan_checks_general_frame_outcome_matches_jax(regs, lights):
    """A 16x16 frame (2 bounces, NEE) on the general path, through the
    dense and the sparse pdf sweep, under the NaN checks passes in both
    packages: the sweeps divide only in the lanes that they keep."""
    kw = dict(width=16, height=16, num_bounces=2, shade_fused=False)
    port_scene = frame_scene(regs["port"], VoxelScene, device="cpu")
    jax_scene = frame_scene(regs["jax"], JaxScene)
    if lights == "sparse":
        grid = port_scene.grid
        port_scene = sparse(port_scene.get_arrays(), port_light_arrays,
                            port_lights.build_light_set,
                            port_lights.extract_voxel_lights,
                            regs["port"], grid, device="cpu")
        jax_scene = sparse(jax_scene.get_arrays(), jax_light_arrays,
                           jax_lights.build_light_set,
                           jax_lights.extract_voxel_lights, regs["jax"], grid)
    port = outcome(lambda: Renderer(
        port_config.RenderSettings(**kw), device="cpu").render(
            port_scene, pose(SphericalCamera),
            RenderingPreferences(nee_type=1), 3), validation_layer)
    jax = outcome(lambda: JaxRenderer(jax_config.RenderSettings(
        use_column_trace=False, **kw)).render(
            jax_scene, pose(JaxCamera),
            jax_config.RenderingPreferences(nee_type=1), 3), jax_validation)
    assert port == jax == "passes"

"""The port's whole frame against the JAX package, the scalar oracle and
the stored golden image.

`wavefront_tpu_torch.render.renderer.Renderer(device="cpu")` renders with
the kernels' plain versions.  It is held to:

  * the JAX `Renderer` on the fused-shade path (shade_fused=True) with the
    XLA DDA (use_column_trace=False) and compaction, at max_trace_steps=512
    because the JAX 96-step default stops short of the port's exhaustive
    tracer: max |diff| < 1e-3 and RMS < 1e-5 (tests/test_shade_fused.py);
  * the scalar `OracleRenderer` and tests/golden/config1_256.npz under the
    golden gate of tests/test_golden.py (divergent pixels < 0.5%, RMSE over
    the agreeing pixels < 1e-3);
  * the JAX `Renderer` on a one-chunk worldgen scene with compaction and
    sort_type 0 and 1, which takes the bucket and sort paths;
  * the JAX package's worldgen chunks and bench.py's headline workload.

Images compare in pixel order: radiance does not depend on ray order.
"""

import os

import numpy as np
import pytest
import torch

from wavefront_tpu.core.config import RenderingPreferences as JaxPrefs
from wavefront_tpu.core.config import RenderSettings as JaxSettings
from wavefront_tpu.render import lights as jax_lights
from wavefront_tpu.render.oracle import OracleRenderer
from wavefront_tpu.render.renderer import Renderer as JaxRenderer
from wavefront_tpu.render.scene import VoxelScene as JaxVoxelScene
from wavefront_tpu.world.blocks import BlockRegistry as JaxBlockRegistry
from wavefront_tpu_torch.core.config import (
    RenderingPreferences,
    RenderSettings,
    WorldSettings,
)
from wavefront_tpu_torch.headline import (
    build_scene,
    config1_grid,
    config1_pose,
    headline_setup,
)
from wavefront_tpu_torch.render.renderer import Renderer
from wavefront_tpu_torch.render.scene import VoxelScene, scene_arrays_from_numpy
from wavefront_tpu_torch.world.blocks import BlockRegistry

ASSETS = "assets"
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "config1_256.npz")


def golden_gate(got, want):
    assert got.shape == want.shape
    assert np.all(np.isfinite(got)), "image has NaN/Inf"
    diff = np.abs(got - want).max(axis=-1)
    agree = diff < 1e-3
    frac = 1.0 - agree.mean()
    rmse = float(np.sqrt(np.mean((got[agree] - want[agree]) ** 2)))
    assert frac < 0.005, f"{frac:.2%} pixels diverge"
    assert rmse < 1e-3, f"RMSE {rmse}"


def close(got, want):
    assert np.all(np.isfinite(got))
    d = np.abs(got - want)
    assert d.max() < 1e-3, d.max()
    assert np.sqrt((d ** 2).mean()) < 1e-5


@pytest.fixture(scope="module")
def registries():
    return BlockRegistry.load(ASSETS), JaxBlockRegistry.load(ASSETS)


@pytest.fixture(scope="module")
def config1(registries):
    reg, jreg = registries
    grid = config1_grid(reg)
    return (VoxelScene(reg, grid, (0, 0, 0), max_light_prims=256,
                       device="cpu"),
            JaxVoxelScene(jreg, grid, (0, 0, 0), max_light_prims=256),
            grid)


def _port(scene, basis, nee, frame=3, **kw):
    s = RenderSettings(**kw)
    return Renderer(s, device="cpu").render(
        scene, basis, RenderingPreferences(nee_type=nee), frame_count=frame)


def _jax(scene, basis, nee, frame=3, sort_type=0, **kw):
    s = JaxSettings(shade_fused=True, use_column_trace=False,
                    max_trace_steps=512, **kw)
    return np.asarray(JaxRenderer(s).render(
        scene, basis, JaxPrefs(nee_type=nee, sort_type=sort_type),
        frame_count=frame))


FRAME = dict(width=48, height=48, num_bounces=2, compaction=True)


@pytest.mark.parametrize("nee", [0, 1, 2])
def test_frame_matches_jax_renderer(config1, nee):
    port_scene, jax_scene, _ = config1
    basis = config1_pose()
    got = _port(port_scene, basis, nee, **FRAME)
    assert got.shape == (48, 48, 3)
    assert got.mean() > 1e-3
    close(got, _jax(jax_scene, basis, nee, **FRAME))


@pytest.mark.parametrize("nee", [0, 1])
def test_frame_matches_oracle(config1, registries, nee):
    port_scene, _, grid = config1
    basis = config1_pose()
    got = _port(port_scene, basis, nee, **FRAME)
    ls = jax_lights.build_from_grid(grid, np.zeros(3), registries[1], 256)
    oracle = OracleRenderer(JaxSettings(width=48, height=48, num_bounces=2),
                            registries[1], grid, (0, 0, 0), ls)
    want = oracle.render(basis.eye, basis.front, basis.right, basis.up,
                         frame_count=3, nee_type=nee)
    golden_gate(got, want)


def test_frame_matches_stored_golden(config1):
    port_scene, _, _ = config1
    blob = np.load(GOLDEN)
    w, h, bounces, nee, frame = (int(x) for x in blob["meta"])
    got = _port(port_scene, config1_pose(), nee, frame=frame, width=w,
                height=h, num_bounces=bounces)
    golden_gate(got, blob["image"])


def test_supersampling_scale2(config1):
    port_scene, jax_scene, _ = config1
    basis = config1_pose()
    kw = dict(width=24, height=24, num_bounces=1, scale=2)
    got = _port(port_scene, basis, 1, **kw)
    assert got.shape == (24, 24, 3)
    close(got, _jax(jax_scene, basis, 1, **kw))


def test_jitter_matches_jax(config1):
    port_scene, jax_scene, _ = config1
    basis = config1_pose()
    kw = dict(width=24, height=16, num_bounces=1, jitter=0.75)
    got = _port(port_scene, basis, 1, **kw)
    close(got, _jax(jax_scene, basis, 1, **kw))
    assert not np.array_equal(got, _port(port_scene, basis, 1, frame=4, **kw))


@pytest.fixture(scope="module")
def one_chunk(registries):
    reg, jreg = registries
    grid, origin = build_scene(reg, WorldSettings(), span=0)
    return (VoxelScene(reg, grid, origin, max_light_prims=1024, device="cpu"),
            JaxVoxelScene(jreg, grid, origin, max_light_prims=1024))


@pytest.mark.parametrize("sort_type", [0, 1])
def test_worldgen_chunk_sort_and_compaction(one_chunk, sort_type):
    from wavefront_tpu_torch.core.camera import SphericalCamera

    port_scene, jax_scene = one_chunk
    cam = SphericalCamera()
    cam.set_root_position([16.0, 20.0, 16.0])
    cam.offset = 18.0
    cam.yaw = 0.6
    cam.pitch = -0.6
    basis = cam.eye_front_right_up()
    kw = dict(width=32, height=24, num_bounces=4, compaction=True)
    got = Renderer(RenderSettings(**kw), device="cpu").render(
        port_scene, basis, RenderingPreferences(nee_type=1,
                                                sort_type=sort_type),
        frame_count=2)
    assert got.mean() > 1e-3
    close(got, _jax(jax_scene, basis, 1, frame=2, sort_type=sort_type, **kw))


def test_worldgen_matches_jax(registries):
    """The port's copy of the generator makes the JAX package's chunks,
    through the native library when it is built and through NumPy."""
    from wavefront_tpu.core.config import WorldSettings as JaxWorld
    from wavefront_tpu.world.worldgen import WorldGenerator as JaxGen
    from wavefront_tpu_torch.world.worldgen import WorldGenerator

    reg, jreg = registries
    port = WorldGenerator(WorldSettings(worldgen_seed=3), reg)
    ref = JaxGen(JaxWorld(worldgen_seed=3), jreg)
    for pos in ((0, 0, 0), (-1, 0, 2), (1, -1, -1)):
        want = ref._generate_chunk_numpy(pos)
        np.testing.assert_array_equal(port._generate_chunk_numpy(pos), want)
        np.testing.assert_array_equal(port.generate_chunk(pos), want)


def test_scene_arrays_from_numpy_round_trip(config1):
    """The JAX SceneArrays carried across equal the port's own scene
    arrays built from the same grid (its own light-set build included)."""
    port_scene, jax_scene, _ = config1
    ja = jax_scene.get_arrays()
    d = {f: np.asarray(getattr(ja, f)) for f in ja._fields
         if f not in ("lights", "winpack")}
    d["lights"] = {f: np.asarray(getattr(ja.lights, f))
                   for f in ja.lights._fields}
    carried = scene_arrays_from_numpy(d, device="cpu")
    own = port_scene.get_arrays()
    assert carried.grid_origin == own.grid_origin == (0, 0, 0)
    for f in ("grid", "transparent", "translucent", "luminescent",
              "atlas_packed"):
        np.testing.assert_array_equal(getattr(carried, f).numpy(),
                                      getattr(own, f).numpy(), err_msg=f)
        np.testing.assert_array_equal(getattr(carried, f).numpy(),
                                      d[f], err_msg=f)
    assert carried.lights.num_prims == own.lights.num_prims > 0
    for f in carried.lights._fields:
        if f == "num_prims":
            continue
        a = getattr(carried.lights, f).numpy()
        np.testing.assert_array_equal(a, getattr(own.lights, f).numpy(),
                                      err_msg=f)
        np.testing.assert_array_equal(
            a, d["lights"][f].astype(a.dtype), err_msg=f)
    assert carried.lights.dense and own.lights.dense


@pytest.mark.parametrize("settings_kw,prefs_kw", [
    (dict(cache_primary=True), {}),
    (dict(shade_fused=False), {}),
    (dict(debug_stage="notex"), {}),
    (dict(shade_bf16=True), {}),
    ({}, dict(debug_view=1)),
])
def test_unported_paths_raise(config1, settings_kw, prefs_kw):
    port_scene, _, _ = config1
    r = Renderer(RenderSettings(width=8, height=8, num_bounces=1,
                                **settings_kw), device="cpu")
    with pytest.raises(NotImplementedError):
        r.render(port_scene, config1_pose(), RenderingPreferences(**prefs_kw))


def test_render_batch_and_entities_raise(config1):
    with pytest.raises(NotImplementedError):
        Renderer(RenderSettings(), device="cpu").render_batch()
    with pytest.raises(NotImplementedError):
        config1[0].add_object("cube", None, None, None)


def test_audit_reports_truncation(config1):
    """aux["truncated"] counts rays that ran out of the tracer's budget."""
    port_scene, _, _ = config1
    s = RenderSettings(width=16, height=16, num_bounces=1, trace_audit=True)
    _, aux = Renderer(s, device="cpu").render(
        port_scene, config1_pose(), with_aux=True)
    assert aux == {"truncated": 0, "nee_overflow": 0}
    _, aux = Renderer(s.replace(trace_events=2), device="cpu").render(
        port_scene, config1_pose(), with_aux=True)
    assert aux["truncated"] > 0
    assert torch.is_tensor(Renderer(s, device="cpu").render(
        port_scene, config1_pose(), as_numpy=False))


def test_headline_setup_matches_bench():
    """The port's headline workload is bench.py's: same grid, origin,
    camera pose, NEE mode, frame settings and light set."""
    import bench

    jscene, jsettings, jbasis, jprefs = bench.headline_setup(96, 54, 4)
    scene, settings, basis, prefs = headline_setup(96, 54, 4, device="cpu")
    np.testing.assert_array_equal(scene.grid, jscene.grid)
    assert scene.grid.shape == (160, 32, 160)
    assert scene.grid_origin == tuple(int(v) for v in jscene.grid_origin)
    for f in ("eye", "front", "right", "up"):
        np.testing.assert_array_equal(getattr(basis, f), getattr(jbasis, f))
    assert prefs.nee_type == jprefs.nee_type == 1
    for f in ("width", "height", "num_bounces", "scale", "jitter",
              "compaction", "trace_audit", "max_trace_steps"):
        assert getattr(settings, f) == getattr(jsettings, f), f
    lights = scene.get_arrays().lights
    want = jax_lights.build_from_grid(jscene.grid, jscene.grid_origin,
                                      jscene.registry, 1024)
    assert lights.num_prims == want.num_prims == 6
    assert lights.dense and tuple(lights.ancestors.shape) == (16, 8)
    np.testing.assert_array_equal(lights.p0.numpy(), want.p0)

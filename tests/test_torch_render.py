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
  * the JAX package's worldgen chunks and bench.py's headline workload;
  * on the general (non-fused) shade path, the JAX `Renderer` with
    shade_fused=False: with and without NEE, with a cube entity, with a
    sparse light set, with debug_view=1 and under each debug_stage; and
    the port's own fused frame with an entity;
  * with shade_bf16 (the bf16 color pipeline), the JAX `Renderer` on both
    paths under tests/test_shade_fused.py's relative bounds between its
    two bf16 paths (max 3e-2, RMS 2e-3 relative to 1 + |pixel|).

Images compare in pixel order: radiance does not depend on ray order.
Where a frame's decisions can flip on an ulp (a stochastic BVH descent, a
scatter threshold), the comparison falls back from `close` to the golden
gate, as stated at the test.
"""

import os
import warnings

import numpy as np
import pytest
import torch

from wavefront_tpu.core.config import RenderingPreferences as JaxPrefs
from wavefront_tpu.core.config import RenderSettings as JaxSettings
from wavefront_tpu.render import lights as jax_lights
from wavefront_tpu.render.oracle import OracleRenderer
from wavefront_tpu.render.renderer import Renderer as JaxRenderer
from wavefront_tpu.render.scene import VoxelScene as JaxVoxelScene
from wavefront_tpu.render.scene import _light_arrays as jax_light_arrays
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
    general_setup,
    headline_setup,
)
from wavefront_tpu_torch.kernels.shade import shade_pass
from wavefront_tpu_torch.kernels.texel import texel_fetch
from wavefront_tpu_torch.render.renderer import Renderer
from wavefront_tpu_torch.render.scene import VoxelScene, scene_arrays_from_numpy
from wavefront_tpu_torch.world import meshes
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
    with pytest.raises(ValueError):     # an aux value past uint8
        scene_arrays_from_numpy(dict(d, aux_grid=d["aux_grid"] + 256),
                                device="cpu")
    own = port_scene.get_arrays()
    assert carried.grid_origin == own.grid_origin == (0, 0, 0)
    for f in ("grid", "aux_grid", "transparent", "translucent",
              "luminescent", "atlas_packed"):
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


def test_render_batch_and_entities_raise(config1):
    """render_batch is ported (tests/test_torch_batch.py) and refuses an
    empty batch; an unknown debug_stage raises."""
    with pytest.raises(ValueError):
        Renderer(RenderSettings(width=8, height=8, num_bounces=1),
                 device="cpu").render_batch(config1[0], config1_pose(), k=0)
    with pytest.raises(ValueError):
        Renderer(RenderSettings(width=8, height=8, num_bounces=1,
                                debug_stage="nosuchstage"),
                 device="cpu").render(config1[0], config1_pose())


# ---- the general (non-fused) shade path ----


def _numpy_fields(arrays):
    d = {f: np.asarray(getattr(arrays, f)) for f in arrays._fields
         if f not in ("lights", "winpack")}
    d["lights"] = {f: np.asarray(getattr(arrays.lights, f))
                   for f in arrays.lights._fields}
    return d


def _jax_general(scene, basis, nee, frame=3, debug_view=0, **kw):
    s = JaxSettings(shade_fused=False, use_column_trace=False,
                    max_trace_steps=512, **kw)
    return np.asarray(JaxRenderer(s).render(
        scene, basis, JaxPrefs(nee_type=nee, debug_view=debug_view),
        frame_count=frame))


def _port_general(scene, basis, nee, frame=3, debug_view=0, **kw):
    s = RenderSettings(shade_fused=False, **kw)
    return Renderer(s, device="cpu").render(
        scene, basis, RenderingPreferences(nee_type=nee,
                                           debug_view=debug_view),
        frame_count=frame)


@pytest.mark.parametrize("nee", [0, 1, 2])
def test_general_frame_matches_jax(config1, nee):
    port_scene, jax_scene, _ = config1
    basis = config1_pose()
    got = _port_general(port_scene, basis, nee, **FRAME)
    assert got.mean() > 1e-3
    close(got, _jax_general(jax_scene, basis, nee, **FRAME))


def test_general_frame_indexed_texels(config1):
    """shade_texel_kernel=False asks for the indexed read in both
    packages; it fetches the texels the kernel path fetches."""
    port_scene, jax_scene, _ = config1
    basis = config1_pose()
    kw = dict(FRAME, shade_texel_kernel=False)
    got = _port_general(port_scene, basis, 1, **kw)
    np.testing.assert_array_equal(
        got, _port_general(port_scene, basis, 1, **FRAME))
    close(got, _jax_general(jax_scene, basis, 1, **kw))


@pytest.fixture(scope="module")
def config1_cube(registries):
    """Config 1 plus the ego cube of tests/test_shade_fused.py."""
    reg, jreg = registries
    grid = config1_grid(reg)
    port = VoxelScene(reg, grid, (0, 0, 0), max_light_prims=256, device="cpu")
    jax_scene = JaxVoxelScene(jreg, grid, (0, 0, 0), max_light_prims=256)
    verts, uv, tex = meshes.unitcube()
    verts = verts + np.float32([7.0, 6.5, 4.0])
    port.add_object("ego", verts, uv, tex)
    jax_scene.add_object("ego", verts, uv, tex)
    return port, jax_scene


@pytest.mark.parametrize("nee", [0, 1])
def test_general_frame_with_entity_matches_jax(config1, config1_cube, nee):
    port_scene, jax_scene = config1_cube
    basis = config1_pose()
    got = _port_general(port_scene, basis, nee, **FRAME)
    close(got, _jax_general(jax_scene, basis, nee, **FRAME))
    # the cube shades: the frame differs from the cube-free one
    assert not np.array_equal(got, _port_general(config1[0], basis, nee,
                                                 **FRAME))


@pytest.mark.parametrize("nee", [0, 1])
def test_fused_frame_with_entity(config1_cube, nee):
    """The fused kernel with the entity stream against the port's own
    general path (tests/test_shade_fused.py: bit-exact without NEE,
    max 1e-3 / RMS 1e-5 with it) and against the JAX fused frame."""
    port_scene, jax_scene = config1_cube
    basis = config1_pose()
    fused = _port(port_scene, basis, nee, **FRAME)
    general = _port_general(port_scene, basis, nee, **FRAME)
    if nee == 0:
        np.testing.assert_array_equal(fused, general)
    else:
        close(fused, general)
    close(fused, _jax(jax_scene, basis, nee, **FRAME))


@pytest.fixture(scope="module")
def sparse_scene(config1):
    """Config 1 with its light set rebuilt as a sparse one
    (dense_threshold forced low), as arrays for both packages."""
    _, jax_scene, grid = config1
    ja = jax_scene.get_arrays()
    p0, e1, e2, power = jax_lights.extract_voxel_lights(
        grid, np.zeros(3), jax_scene.registry)[:4]
    ls = jax_lights.build_light_set(p0, e1, e2, power,
                                    np.zeros(len(p0), bool), 256,
                                    dense_threshold=8)
    ja = ja._replace(lights=jax_light_arrays(ls))
    assert not ja.lights.dense
    return scene_arrays_from_numpy(_numpy_fields(ja), device="cpu"), ja


def test_general_frame_sparse_lights_matches_jax(config1, sparse_scene):
    """The stochastic descent steps the other way where a uniform lands
    within rounding of a branch probability, so the frame is held to the
    golden gate; max_nee_hits=2 makes both packages drop the same
    crossings."""
    port_arrays, jax_arrays = sparse_scene
    basis = config1_pose()
    for kw in (FRAME, dict(FRAME, max_nee_hits=2, trace_audit=True)):
        got = _port_general(port_arrays, basis, 1, **kw)
        assert got.mean() > 1e-3
        golden_gate(got, _jax_general(jax_arrays, basis, 1, **kw))
    # the dense path is another estimator of the same image
    dense = _port_general(config1[0], basis, 1, **FRAME)
    assert not np.array_equal(got, dense)
    assert abs(got.mean() - dense.mean()) < 0.05 * dense.mean()


def test_sparse_lights_fall_back_with_a_warning(sparse_scene):
    """shade_fused=True on a sparse light set runs the general path and
    says so; without NEE the fused kernel runs and nothing is said."""
    port_arrays, _ = sparse_scene
    basis = config1_pose()
    kw = dict(width=16, height=16, num_bounces=2)
    r = Renderer(RenderSettings(shade_fused=True, **kw), device="cpu")
    with pytest.warns(UserWarning, match="falling back"):
        got = r.render(port_arrays, basis, RenderingPreferences(nee_type=1),
                       frame_count=3)
    np.testing.assert_array_equal(
        got, _port_general(port_arrays, basis, 1, **kw))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        r.render(port_arrays, basis, RenderingPreferences(nee_type=0))


def test_general_frame_overflow_audit(sparse_scene):
    """aux["nee_overflow"] counts rays whose light crossings overflowed
    the sparse sweep's slots; rays through the 3x3x3 lamp cross two
    prims, so one slot overflows and eight do not."""
    port_arrays, _ = sparse_scene
    basis = config1_pose()
    kw = dict(width=32, height=32, num_bounces=2, shade_fused=False,
              trace_audit=True)
    prefs = RenderingPreferences(nee_type=1)
    _, aux = Renderer(RenderSettings(**kw), device="cpu").render(
        port_arrays, basis, prefs, with_aux=True)
    assert aux == {"truncated": 0, "nee_overflow": 0}
    _, aux = Renderer(RenderSettings(max_nee_hits=1, **kw),
                      device="cpu").render(port_arrays, basis, prefs,
                                           with_aux=True)
    assert aux["nee_overflow"] > 0


def test_debug_view_matches_jax(config1):
    """debug_view=1 shows the bounce-1 ray layout; without a sort the ray
    slots are the pixels, so both packages paint the same image."""
    port_scene, jax_scene, _ = config1
    basis = config1_pose()
    kw = dict(width=48, height=40, num_bounces=2)
    got = _port_general(port_scene, basis, 1, debug_view=1, **kw)
    # one ulp: XLA divides by 1023 as a multiplication by its reciprocal
    np.testing.assert_allclose(
        got, _jax_general(jax_scene, basis, 1, debug_view=1, **kw),
        rtol=3e-7, atol=0)
    assert got[..., :2].max() > 0 and not got[..., 2].any()
    # the fused path carries the same buffer, and a sort permutes it back
    np.testing.assert_array_equal(
        got, Renderer(RenderSettings(**kw), device="cpu").render(
            port_scene, basis, RenderingPreferences(nee_type=1,
                                                    debug_view=1)))
    sorted_view = Renderer(RenderSettings(compaction=True, **kw),
                           device="cpu").render(
        port_scene, basis, RenderingPreferences(nee_type=1, debug_view=1))
    assert sorted_view.shape == got.shape and sorted_view[..., :2].max() > 0


@pytest.mark.parametrize("stage", ["freetrace", "notex", "nonee_pdf"])
def test_debug_stage_matches_jax(config1, stage):
    port_scene, jax_scene, _ = config1
    basis = config1_pose()
    kw = dict(FRAME, debug_stage=stage)
    got = _port_general(port_scene, basis, 1, **kw)
    assert np.all(np.isfinite(got))
    want = _jax_general(jax_scene, basis, 1, **kw)
    if stage == "notex":
        # every surface emits 1000 * 0.5 * cos here, so pixels reach the
        # hundreds, where one float32 ulp is 3e-5: compare relative to the
        # pixel, as tests/test_torch_shade.py does for lamp radiance
        scale = np.maximum(1.0, np.abs(want))
        close(got / scale, want / scale)
    else:
        close(got, want)
    assert not np.array_equal(got, _port_general(port_scene, basis, 1,
                                                 **FRAME))
    if stage == "freetrace":
        # the fused path takes the same synthetic hits
        close(_port(port_scene, basis, 1, **kw), got)


# ---- the bf16 color pipeline (shade_bf16) ----


def rel_close(got, want):
    """tests/test_shade_fused.py's bounds between the JAX package's two
    bf16 paths: relative to 1 + |pixel| (lamp pixels reach the hundreds),
    max < 3e-2 and RMS < 2e-3.  Each package rounds its bf16 ops at its
    own places (XLA on the CPU may keep float32 across fused ops, the port
    rounds after each); no draw compares against a bf16 color (alpha and
    metal stay float32), so no ray takes another path."""
    assert np.all(np.isfinite(got))
    rel = np.abs(got - want) / (1.0 + np.abs(want))
    assert rel.max() < 3e-2, rel.max()
    assert np.sqrt((rel ** 2).mean()) < 2e-3


@pytest.mark.parametrize("fused,entity", [(True, False), (False, False),
                                          (False, True)],
                         ids=["fused", "general", "general-entity"])
def test_bf16_frame_matches_jax(config1, config1_cube, fused, entity):
    """A 2-bounce shade_bf16 frame against the JAX `Renderer`'s, on the
    fused and the general path; the float32 frame differs from it."""
    port_scene, jax_scene = config1_cube if entity else config1[:2]
    basis = config1_pose()
    kw = dict(FRAME, shade_bf16=True)
    port, jax = (_port, _jax) if fused else (_port_general, _jax_general)
    got = port(port_scene, basis, 1, **kw)
    assert got.mean() > 1e-3
    rel_close(got, jax(jax_scene, basis, 1, **kw))
    assert not np.array_equal(got, port(port_scene, basis, 1, **FRAME))


@pytest.mark.parametrize("stage", ["freetrace", "notex", "nonee_pdf"])
def test_bf16_debug_stages(config1, stage):
    """Each stage-isolation variant with shade_bf16: "notex" and
    "nonee_pdf" against the JAX `Renderer` under the bf16 bounds (notex
    comes out equal); "freetrace" (every ray alive on synthetic hits, a
    black frame here) on the fused path against the general one, bit for
    bit."""
    port_scene, jax_scene, _ = config1
    basis = config1_pose()
    kw = dict(FRAME, debug_stage=stage, shade_bf16=True)
    got = _port_general(port_scene, basis, 1, **kw)
    if stage == "freetrace":
        assert np.all(np.isfinite(got))
        np.testing.assert_array_equal(
            _port(port_scene, basis, 1, **kw), got)
    else:
        assert got.mean() > 1e-3
        rel_close(got, _jax_general(jax_scene, basis, 1, **kw))


@pytest.mark.parametrize("fused", [None, False], ids=["fused", "general"])
def test_bf16_throughput_keeps_its_dtype(config1_cube, fused, monkeypatch):
    """tp is bfloat16 through every bounce's sort, compaction bucket and
    shade, and radiance float32, with an entity in view; the fused path's
    bf16 frame agrees with the general path's as the JAX package's two
    bf16 paths do."""
    from wavefront_tpu_torch.render import renderer as port_renderer

    sorts, shades = [], []
    sort = port_renderer.coherence_sort

    def sort_spy(scene, o, d, tp, rad, rid, *riders, **kw):
        out = sort(scene, o, d, tp, rad, rid, *riders, **kw)
        sorts.append(({c.dtype for c in (*tp, *out[2])},
                      {c.dtype for c in (*rad, *out[3])}))
        return out

    def shade_spy(*a, **kw):
        out = shade_pass(*a, **kw)
        shades.append((a[2].x.shape[0], {c.dtype for c in (*a[7], *out[2])},
                       {c.dtype for c in (*a[8], *out[3])}))
        return out

    monkeypatch.setattr(port_renderer, "coherence_sort", sort_spy)
    port_scene, _ = config1_cube
    basis = config1_pose()
    settings = RenderSettings(width=32, height=32, num_bounces=3,
                              compaction=True, shade_fused=fused,
                              shade_bf16=True)
    img, _ = port_renderer.render_frame(
        port_scene.get_arrays(), basis.eye, basis.front, basis.right,
        basis.up, 3, settings=settings, nee_type=1, sort_type=0,
        shade=shade_spy)
    assert img.dtype == torch.float32
    assert len(sorts) == 3
    assert all(d == ({torch.bfloat16}, {torch.float32}) for d in sorts)
    if fused is None:
        # a bucket below n shades the compacted head; the tail is joined
        assert len(shades) == 3 and min(m for m, _, _ in shades) < 32 * 32
        assert all(t == {torch.bfloat16} and r == {torch.float32}
                   for _, t, r in shades)
        general = port_renderer.render_frame(
            port_scene.get_arrays(), basis.eye, basis.front, basis.right,
            basis.up, 3, settings=settings.replace(shade_fused=False),
            nee_type=1, sort_type=0)[0]
        rel_close(img.numpy(), general.numpy())
    else:
        assert shades == []


def test_general_frame_uses_the_texel_wrapper(config1, monkeypatch):
    """The general path fetches its texels through `texel_fetch`, once per
    bounce, with the shade's 8 channels; the fused path never does."""
    from wavefront_tpu_torch.render import renderer as port_renderer

    calls = []

    def spy(atlas, tex, u, v, channels=None):
        calls.append((tex.dtype, tuple(channels), tex.shape[0]))
        return texel_fetch(atlas, tex, u, v, channels=channels)

    port_scene, _, _ = config1
    basis = config1_pose()
    r = Renderer(RenderSettings(width=16, height=16, num_bounces=3,
                                shade_fused=False), device="cpu")
    monkeypatch.setattr(port_renderer, "texel_fetch", spy)
    img, _ = port_renderer.render_frame(
        port_scene.get_arrays(), basis.eye, basis.front, basis.right,
        basis.up, 0, settings=r.settings, nee_type=1, sort_type=0, texel=spy)
    assert calls == [(torch.int32, (0, 1, 2, 3, 4, 5, 6, 8), 256)] * 3
    calls.clear()
    port_renderer.render_frame(
        port_scene.get_arrays(), basis.eye, basis.front, basis.right,
        basis.up, 0, settings=r.settings.replace(shade_fused=None),
        nee_type=1, sort_type=0, texel=spy)
    assert calls == []


def test_general_setup_small():
    """general_setup at 96x54: a sparse light set, the ego cube in the
    pool, the general path, no truncated ray and no overflowed sweep."""
    scene, settings, basis, prefs = general_setup(96, 54, 4, device="cpu")
    arrays = scene.get_arrays()
    assert not arrays.lights.dense and arrays.lights.num_prims > 256
    assert tuple(arrays.lights.node_min.shape) == (1024, 3)
    assert int(arrays.tri_active.sum()) == 12
    assert settings.shade_fused is False and settings.shade_texel_kernel
    assert settings.compaction and settings.trace_audit
    assert prefs.nee_type == 1
    img, aux = Renderer(settings, device="cpu").render(
        scene, basis, prefs, with_aux=True)
    assert img.shape == (54, 96, 3) and np.all(np.isfinite(img))
    assert img.mean() > 1e-3
    assert aux == {"truncated": 0, "nee_overflow": 0}
    # the cube fills the middle of the view: the frame differs without it
    scene.remove_object("ego")
    assert not np.array_equal(
        img, Renderer(settings, device="cpu").render(scene, basis, prefs))


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

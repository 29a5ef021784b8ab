"""The port's counterparts of the JAX package's remaining public helpers
and options, against the JAX functions on the same seeded inputs:

  * `render_frame(use_entities=False)` with a live entity against the JAX
    frame (max |diff| 1e-3, RMS 1e-5, the frame tolerance of
    tests/test_torch_render.py), and equal bit for bit to the entity-free
    frame on the fused and the general path; `Renderer` and
    `DistributedRenderer` decide it from host state;
  * `extract_voxel_lights` for both `merge` values, all six arrays equal;
  * `raygen`, `accumulate_radiance` (with a planted q == 0 lane),
    `kernels.shade.pack_hits`, `BlockRegistry.material_offset`, the
    morton helpers and `V3.full_like`, exactly;
  * `dda_trace` and the JAX options of `window_trace` (grid_origin,
    t_min, t_max, air_id, with_truncated, packed_hits) against the JAX
    `dda_trace`: hit words equal, t within the tracer tolerance of
    tests/test_torch_trace.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_thread  # noqa: F401

from wavefront_tpu.core import morton as jax_morton
from wavefront_tpu.core.config import RenderSettings as JaxSettings
from wavefront_tpu.core.vec3 import V3 as JaxV3
from wavefront_tpu.kernels import shade as jax_shade
from wavefront_tpu.render import intersect as jax_intersect
from wavefront_tpu.render import lights as jax_lights
from wavefront_tpu.render import renderer as jax_renderer
from wavefront_tpu.render import wavefront as jax_wavefront
from wavefront_tpu.render.scene import VoxelScene as JaxVoxelScene
from wavefront_tpu.world.blocks import BlockRegistry as JaxBlockRegistry
from wavefront_tpu_torch.core import morton
from wavefront_tpu_torch.core.config import RenderSettings
from wavefront_tpu_torch.core.vec3 import V3
from wavefront_tpu_torch.headline import config1_grid, config1_pose
from wavefront_tpu_torch.kernels import shade
from wavefront_tpu_torch.kernels.window_trace import window_trace
from wavefront_tpu_torch.parallel.mesh import DistributedRenderer
from wavefront_tpu_torch.render import intersect, lights, renderer, wavefront
from wavefront_tpu_torch.render.renderer import Renderer, render_frame
from wavefront_tpu_torch.render.scene import VoxelScene
from wavefront_tpu_torch.world import meshes
from wavefront_tpu_torch.world.blocks import BlockRegistry

ASSETS = "assets"
FRAME = dict(width=32, height=32, num_bounces=2, compaction=True)
T_ATOL = 2e-4       # tests/test_torch_trace.py's tracer tolerance


@pytest.fixture(scope="module")
def registries():
    return BlockRegistry.load(ASSETS), JaxBlockRegistry.load(ASSETS)


@pytest.fixture(scope="module")
def scenes(registries):
    """Config 1 without and with the ego cube of tests/test_shade_fused.py
    (port, port, JAX with the cube)."""
    reg, jreg = registries
    grid = config1_grid(reg)
    plain = VoxelScene(reg, grid, (0, 0, 0), max_light_prims=256,
                       device="cpu")
    cube = VoxelScene(reg, grid, (0, 0, 0), max_light_prims=256,
                      device="cpu")
    jax_cube = JaxVoxelScene(jreg, grid, (0, 0, 0), max_light_prims=256)
    verts, uv, tex = meshes.unitcube()
    verts = verts + np.float32([7.0, 6.5, 4.0])
    cube.add_object("ego", verts, uv, tex)
    jax_cube.add_object("ego", verts, uv, tex)
    return plain, cube, jax_cube


def _frame(scene, use_entities, fused=True, nee=1, **kw):
    basis = config1_pose()
    img, _ = render_frame(
        scene.get_arrays(), basis.eye, basis.front, basis.right, basis.up, 3,
        settings=RenderSettings(shade_fused=fused, **FRAME, **kw),
        nee_type=nee, sort_type=0, use_entities=use_entities)
    return img.numpy()


def close(got, want):
    assert np.all(np.isfinite(got))
    d = np.abs(got - want)
    assert d.max() < 1e-3, d.max()
    assert np.sqrt((d ** 2).mean()) < 1e-5


def test_use_entities_false_matches_jax(scenes):
    _, cube, jax_cube = scenes
    s = JaxSettings(shade_fused=True, use_column_trace=False,
                    max_trace_steps=512, **FRAME)
    fn = jax.jit(functools.partial(
        jax_renderer.render_frame, settings=s, nee_type=1, sort_type=0,
        debug_view=0, use_entities=False))
    want, _ = fn(jax_cube.get_arrays(),
                 *(jnp.asarray(getattr(config1_pose(), k), jnp.float32)
                   for k in ("eye", "front", "right", "up")),
                 np.uint32(3))
    close(_frame(cube, False), np.asarray(want))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "general"])
def test_use_entities_paths(scenes, fused):
    """False drops a live entity: the frame equals the entity-free one bit
    for bit; True shades it; True without a live triangle renders the
    frame of False."""
    plain, cube, _ = scenes
    free = _frame(plain, False, fused)
    np.testing.assert_array_equal(_frame(cube, False, fused), free)
    assert not np.array_equal(_frame(cube, True, fused), free)
    np.testing.assert_array_equal(_frame(plain, True, fused), free)


def test_renderers_decide_use_entities_on_the_host(scenes, monkeypatch):
    """`Renderer` and `DistributedRenderer` sweep the entity triangles for
    a VoxelScene with entities or for bare arrays, and never for a
    VoxelScene without them; the primary cache keys on the choice."""
    plain, cube, _ = scenes
    swept = []
    sweep = renderer.triangle_sweep

    def spy(*a, **kw):
        swept.append(1)
        return sweep(*a, **kw)

    monkeypatch.setattr(renderer, "triangle_sweep", spy)
    s = RenderSettings(width=16, height=16, num_bounces=1, shade_fused=False)
    basis = config1_pose()
    mesh = DistributedRenderer(s, ["cpu", "cpu"])
    for scene, want in ((plain, False), (cube, True),
                        (plain.get_arrays(), True)):
        for call in (lambda: Renderer(s, device="cpu").render(scene, basis),
                     lambda: mesh.render(scene, basis)):
            swept.clear()
            call()
            assert bool(swept) == want
    r = Renderer(s.replace(cache_primary=True), device="cpu")
    r.render(plain, basis)
    assert r._primary[1][-1][-1] is False


@pytest.mark.parametrize("merge", [True, False])
def test_extract_voxel_lights_matches_jax(registries, merge):
    reg, jreg = registries
    grid = np.full((12, 8, 12), reg.air, np.uint8)
    grid[:, 0, :] = reg.block_idx("stone")
    grid[2:5, 1, 3:7] = reg.block_idx("lamp")      # a slab that merges
    grid[8, 5, 9] = reg.block_idx("lamp")
    origin = np.int32([-6, 3, 10])
    got = lights.extract_voxel_lights(grid, origin, reg, merge=merge)
    want = jax_lights.extract_voxel_lights(grid, origin, jreg, merge=merge)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    if merge:
        assert len(got[0]) < len(lights.extract_voxel_lights(
            grid, origin, reg, merge=False)[0])


@pytest.mark.parametrize("jitter,seed", [(0.0, None), (0.7, 5)])
def test_raygen_matches_jax(jitter, seed):
    basis = config1_pose()
    cam = (basis.eye, basis.front, basis.right, basis.up)
    got = wavefront.raygen(*cam, 32, 24, jitter=jitter, seed=seed,
                           device="cpu")
    want = jax_wavefront.raygen(*cam, 32, 24, jitter=jitter, seed=seed)
    for g, w in zip(got[:2], want[:2]):
        assert g.shape == (32 * 24, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_accumulate_radiance_matches_jax():
    g = np.random.default_rng(3)
    b, n = 3, 64
    emis = g.random((b, n, 3), np.float32)
    refl = g.random((b, n, 3), np.float32)
    mis = g.random((b, n), np.float32)
    bsdf = g.random((b, n), np.float32)
    nee = g.random((b, n), np.float32)
    valid = g.random((b, n)) > 0.2
    # lane 5: q == 0 at bounce 1 (a zero-probability sample)
    mis[1, 5], bsdf[1, 5], nee[1, 5] = 0.5, 0.0, 0.0
    got = wavefront.accumulate_radiance(*(torch.as_tensor(a) for a in (
        emis, refl, mis, bsdf, nee, valid))).numpy()
    want = np.asarray(jax_wavefront.accumulate_radiance(
        emis, refl, mis, bsdf, nee, valid))
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    # the zero-probability sample keeps its own emission and drops the
    # rest of the path
    np.testing.assert_allclose(
        got[5], emis[0, 5] + refl[0, 5] * emis[1, 5] * (
            bsdf[0, 5] / (nee[0, 5] * mis[0, 5] + (1 - mis[0, 5])
                          * bsdf[0, 5])) * valid[0, 5], rtol=1e-6)


def test_pack_hits_matches_jax():
    g = np.random.default_rng(4)
    n = 256
    f = dict(hit=g.random(n) > 0.3, t=g.random(n, np.float32) * 40,
             owner=g.integers(0, 256, n).astype(np.int32),
             face=g.integers(0, 6, n).astype(np.int32),
             vx=g.integers(-3, 1030, n).astype(np.int32),
             vy=g.integers(-3, 520, n).astype(np.int32),
             vz=g.integers(-3, 1030, n).astype(np.int32),
             entered=g.random(n) > 0.5)
    got = shade.pack_hits(intersect.VoxelHit(
        **{k: torch.as_tensor(v) for k, v in f.items()}))
    want = jax_shade.pack_hits(jax_intersect.VoxelHit(
        **{k: jnp.asarray(v) for k, v in f.items()}))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_material_offset_matches_jax(registries):
    reg, jreg = registries
    for block in range(reg.num_blocks + 1):
        for face in range(6):
            assert reg.material_offset(block, face) \
                == jreg.material_offset(block, face)


def test_morton_helpers_match_jax():
    g = np.random.default_rng(6)
    i = np.concatenate([g.integers(0, 2 ** 16, 500), [0, 1, 0xFFFF, 0x1FFFF]])
    j = g.integers(0, 2 ** 17, len(i))
    np.testing.assert_array_equal(
        morton.spread_bits_2(torch.as_tensor(i)).numpy(),
        np.asarray(jax_morton.spread_bits_2(i.astype(np.uint32))))
    np.testing.assert_array_equal(
        morton.interleave_bits_2(torch.as_tensor(i),
                                 torch.as_tensor(j)).numpy(),
        np.asarray(jax_morton.interleave_bits_2(i.astype(np.uint32),
                                                j.astype(np.uint32))))
    p = (g.standard_normal((300, 3)) * 40).astype(np.float32)
    np.testing.assert_array_equal(
        morton.morton_key_3d(torch.as_tensor(p)).numpy(),
        np.asarray(jax_morton.morton_key_3d(p)))


def test_v3_full_like_matches_jax():
    ref = V3(*(torch.zeros(5, dtype=torch.float32) for _ in range(3)))
    got = V3.full_like(ref, 2.5)
    want = JaxV3.full_like(JaxV3(*(jnp.zeros(5, jnp.float32)
                                   for _ in range(3))), 2.5)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _trace_case():
    """A 16^3 terrain with a glass column, its tables, and 256 rays from
    inside and outside the grid."""
    g = np.random.default_rng(1)
    grid = np.full((16, 16, 16), 255, np.uint8)
    h = (4 + 4 * g.random((16, 16))).astype(int)
    for x in range(16):
        for z in range(16):
            grid[x, : h[x, z], z] = 1
    grid[6, 8:12, 6] = 2
    transparent = np.zeros(256, bool)
    translucent = np.zeros(256, bool)
    transparent[255] = translucent[255] = True
    translucent[2] = True
    o = np.concatenate([np.tile([8.0, 13.0, 8.0], (192, 1)),
                        g.random((64, 3)) * 30 - 7]).astype(np.float32)
    d = g.standard_normal((256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[7] = 0.0
    return grid, transparent, translucent, o, d


def _jax_dda(grid, origin, tables, o, d, aux, **kw):
    return jax_intersect.dda_trace(
        jnp.asarray(grid), jnp.asarray(origin, jnp.int32),
        *(jnp.asarray(t) for t in tables), kw.pop("air_id", 255),
        jnp.asarray(o), jnp.asarray(d),
        aux_grid=None if aux is None else jnp.asarray(aux), **kw)


def _equal_hits(got, want):
    hit = np.asarray(want.hit)
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    for f in ("owner", "face", "vx", "vy", "vz", "entered"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit],
                               rtol=0, atol=T_ATOL)
    np.testing.assert_array_equal(got.t.numpy()[~hit],
                                  np.asarray(want.t)[~hit])


@pytest.mark.parametrize("kw", [
    {},
    dict(t_min=0.5, t_max=9.0, air_id=7),
    dict(max_steps=13, unroll=8),      # 16 steps: some rays run out
], ids=["default", "clip", "budget"])
@pytest.mark.parametrize("skip", [True, False])
def test_dda_trace_matches_jax(kw, skip):
    grid, transparent, translucent, o, d = _trace_case()
    origin = (-3, 2, 5)
    aux = intersect.make_aux_grid(grid, transparent, translucent) \
        if skip else None
    kw = {"max_steps": 512, **kw}
    got = intersect.dda_trace(grid, origin, transparent, translucent,
                              kw.get("air_id", 255), o + origin, d,
                              aux_grid=aux, **{k: v for k, v in kw.items()
                                               if k != "air_id"})
    want = _jax_dda(grid, origin, (transparent, translucent), o + origin,
                    d, aux, **kw)
    _equal_hits(got, want)


def test_window_trace_options_match_jax():
    """The JAX options of the tracer's wrapper on the CPU (its plain
    version), against the JAX DDA on the same rays."""
    grid, transparent, translucent, o, d = _trace_case()
    aux = intersect.make_aux_grid(grid, transparent, translucent)
    scene = type("S", (), dict(grid=torch.as_tensor(grid),
                               aux_grid=torch.as_tensor(aux),
                               grid_origin=(0, 0, 0)))
    origin = (4, -2, 1)
    ov = V3.from_array(torch.as_tensor((o + origin).astype(np.float32)))
    dv = V3.from_array(torch.as_tensor(d))
    vox, trunc = window_trace(
        scene, ov, dv, 512, grid_origin=origin, t_min=0.5, t_max=9.0,
        air_id=7, with_truncated=True, packed_hits=False)
    _equal_hits(vox, _jax_dda(grid, origin, (transparent, translucent),
                              o + origin, d, aux, t_min=0.5, t_max=9.0,
                              air_id=7, max_steps=512))
    assert not bool(trunc.any())
    (pa, _, _), trunc = window_trace(scene, ov, dv, 4, grid_origin=origin,
                                     with_truncated=True)
    assert bool(trunc.any())
    np.testing.assert_array_equal(trunc.numpy(),
                                  intersect.truncated(pa).numpy())

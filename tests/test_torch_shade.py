"""The port's fused shade against the JAX package's.

`wavefront_tpu_torch.kernels.shade.shade_pass` takes its plain version
(`shade_plain`, the function the CUDA kernel is held to on the card by
the `cuda` tests) for CPU tensors.  Here it runs against the JAX
`kernels/shade.py::shade_pass` in interpret mode, as the JAX package's
own tests run it, on 2048 rays of the golden config-1 scene: the same
origins, directions, throughput, radiance and pixel ids, and the packed
hits of the JAX `dda_trace` + `pack_hits`.

Bounds: without NEE every output within 1e-5; with NEE max |diff| < 1e-3
and RMS < 1e-5 (tests/test_shade_fused.py: the TPU kernel forms the NEE
descent probabilities by a matrix product, the port by a walk up the
parents, so they round apart by ulps).  Every output compares by
|diff| / max(1, |value|): origins of missed rays sit 5000 units out and
the radiance of lamp hits reaches ~1000 (emission x1000), where one
float32 ulp is 4.9e-4 and 6.1e-5, and XLA on the CPU may contract a
multiply-add that the port rounds twice.

The same comparison runs with the entity attribute stream (`tri_attrs`):
a cube's closest-hit merge, made once by the port's `entity_attrs`, goes
into both kernels as the same arrays.

The bf16 color build (`color_bf16`) runs against the JAX kernel's under
the bounds stated at its test.

The dense light pick and the dense NEE pdf sweep are also compared on
their own against their JAX twins.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavefront_tpu.core.camera import SphericalCamera
from wavefront_tpu.core.rng import murmur3_combine
from wavefront_tpu.core.vec3 import V3 as JV3
from wavefront_tpu.kernels.shade import pack_hits as jax_pack_hits
from wavefront_tpu.kernels.shade import prep_shade_tables as jax_prep
from wavefront_tpu.kernels.shade import shade_pass as jax_shade_pass
from wavefront_tpu.render import wavefront as jwf
from wavefront_tpu.render.intersect import dda_trace
from wavefront_tpu.render.scene import VoxelScene as JaxVoxelScene
from wavefront_tpu.render.wavefront import raygen_soa as jax_raygen
from wavefront_tpu.world.blocks import BlockRegistry as JaxBlockRegistry
from wavefront_tpu_torch.core import rng
from wavefront_tpu_torch.core.vec3 import V3
from wavefront_tpu_torch.headline import config1_grid
from wavefront_tpu_torch.kernels.shade import (
    MAX_NODES,
    prep_shade_tables,
    shade_pass,
)
from wavefront_tpu_torch.render import wavefront as twf
from wavefront_tpu_torch.render.renderer import entity_attrs
from wavefront_tpu_torch.render.scene import scene_arrays_from_numpy
from wavefront_tpu_torch.world import meshes
from wavefront_tpu_torch.world.blocks import BlockRegistry

N = 2048


def numpy_fields(arrays):
    """The JAX SceneArrays leaves as numpy (lights as a nested dict)."""
    d = {f: np.asarray(getattr(arrays, f)) for f in arrays._fields
         if f not in ("lights", "winpack")}
    d["lights"] = {f: np.asarray(getattr(arrays.lights, f))
                   for f in arrays.lights._fields}
    return d


@pytest.fixture(scope="module")
def scenes():
    grid = config1_grid(BlockRegistry.load("assets"))
    jscene = JaxVoxelScene(JaxBlockRegistry.load("assets"), grid, (0, 0, 0),
                           max_light_prims=256)
    ja = jscene.get_arrays()
    return ja, scene_arrays_from_numpy(numpy_fields(ja), device="cpu")


@pytest.fixture(scope="module")
def lamp_scenes():
    """The golden grid with its lamp block replaced by 20 lamp voxels in
    the air: 120 light prims (a 128-prim, 256-node dense set), a node
    table of 1 KB per ray in the CUDA kernel."""
    reg = BlockRegistry.load("assets")
    grid = config1_grid(reg)
    grid[6:9, 5:8, 6:9] = reg.air
    for x in range(1, 15, 3):
        for z in range(1, 15, 3)[:4]:
            grid[x, 9 + (7 * x + z) % 5, z] = reg.block_idx("lamp")
    jscene = JaxVoxelScene(JaxBlockRegistry.load("assets"), grid, (0, 0, 0),
                           max_light_prims=256)
    ja = jscene.get_arrays()
    return ja, scene_arrays_from_numpy(numpy_fields(ja), device="cpu")


@pytest.fixture(scope="module")
def rays(scenes):
    return _make_rays(scenes[0])


def _make_rays(ja):
    """2048 rays: 1024 camera rays of the golden pose (32x32) and 1024
    bounce-like rays from random points above the terrain in random
    directions, a tenth of them dead; random throughput/radiance and
    shuffled pixel ids; their packed hits from the JAX DDA."""
    cam = SphericalCamera()
    cam.set_root_position([8.0, 8.0, 8.0])
    cam.offset = 14.0
    cam.yaw = 0.7
    cam.pitch = -0.45
    b = cam.eye_front_right_up()
    o, d, _ = jax_raygen(b.eye, b.front, b.right, b.up, 32, 32)
    rng_np = np.random.default_rng(0)
    o2 = rng_np.uniform((0.0, 5.01, 0.0), (16.0, 12.0, 16.0), (N // 2, 3))
    d2 = rng_np.standard_normal((N // 2, 3))
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    o = np.concatenate([np.stack([np.asarray(c) for c in o], -1), o2])
    d = np.concatenate([np.stack([np.asarray(c) for c in d], -1), d2])
    o, d = o.astype(np.float32), d.astype(np.float32)
    d[rng_np.random(N) < 0.1] = 0.0
    tp = rng_np.uniform(0.2, 1.0, (N, 3)).astype(np.float32)
    rad = rng_np.uniform(0.0, 2.0, (N, 3)).astype(np.float32)
    rid = rng_np.permutation(N).astype(np.uint32)
    vox = dda_trace(ja.grid, ja.grid_origin, ja.transparent, ja.translucent,
                    255, jnp.asarray(o), jnp.asarray(d), max_steps=512,
                    aux_grid=ja.aux_grid)
    pa, pb, t = (np.array(x) for x in jax_pack_hits(vox))
    assert (pa & 1).sum() > N // 5
    return dict(o=o, d=d, tp=tp, rad=rad, rid=rid, pa=pa, pb=pb, t=t)


def _jv3(a):
    return JV3(*(jnp.asarray(np.ascontiguousarray(a[:, i])) for i in range(3)))


def _tv3(a):
    return V3(*(torch.as_tensor(np.ascontiguousarray(a[:, i]))
                for i in range(3)))


def _both_shades(scenes, r, nee_type, bounce, t=None, tri_attrs=None,
                 color_bf16=False):
    """(port outputs, JAX outputs) of one shade step on the rays `r`."""
    ja, ta = scenes
    inv_seed = 7 + bounce
    t = r["t"] if t is None else t
    want = jax_shade_pass(
        jax_prep(ja.atlas_packed, ja.lights), ja.grid_origin,
        _jv3(r["o"]), _jv3(r["d"]), jnp.asarray(r["pa"]),
        jnp.asarray(r["pb"]), jnp.asarray(t), _jv3(r["tp"]),
        _jv3(r["rad"]), jnp.asarray(r["rid"]), jnp.uint32(inv_seed),
        jnp.int32(bounce), ja.lights.num_prims, nee_type=nee_type,
        tile=2048, interpret=True, color_bf16=color_bf16,
        tri_attrs=None if tri_attrs is None else tuple(
            jnp.asarray(a) for a in tri_attrs))
    got = shade_pass(
        prep_shade_tables(ta.atlas_packed, ta.lights), ta.grid_origin,
        _tv3(r["o"]), _tv3(r["d"]), torch.as_tensor(r["pa"]),
        torch.as_tensor(r["pb"]), torch.as_tensor(t), _tv3(r["tp"]),
        _tv3(r["rad"]), torch.as_tensor(r["rid"].astype(np.int32)),
        inv_seed, bounce, ta.lights.num_prims, nee_type=nee_type,
        color_bf16=color_bf16,
        tri_attrs=None if tri_attrs is None else tuple(
            torch.as_tensor(a) for a in tri_attrs))
    return got, want


@pytest.mark.parametrize("nee_type,bounce", [(0, 0), (1, 0), (1, 1), (2, 1)])
def test_shade_matches_jax(scenes, rays, nee_type, bounce):
    got, want = _both_shades(scenes, rays, nee_type, bounce)
    _assert_shades_agree(got, want, nee_type)


def test_shade_past_node_table_matches_jax(lamp_scenes):
    """A light set past the headline's small buckets (the CUDA kernel's
    node table at 256 rows): the plain version against the JAX kernel,
    under the NEE bounds."""
    _, ta = lamp_scenes
    assert ta.lights.num_prims == 120 and ta.lights.p0.shape[0] == 128
    assert ta.lights.node_min.shape[0] == 256
    got, want = _both_shades(lamp_scenes, _make_rays(lamp_scenes[0]), 1, 0)
    _assert_shades_agree(got, want, 1)


@pytest.mark.parametrize("which", ["scenes", "lamp_scenes"])
def test_shade_tables_node_table_rows(request, which):
    """The kernel's node table (2P floats a ray) computes rows 1..live-1
    in sibling pairs (odd j, j + 1): every path node lies below `live`, and
    so does the second node of every pair the kernel computes."""
    ta = request.getfixturevalue(which)[1]
    tables = prep_shade_tables(ta.atlas_packed, ta.lights)
    top = max(a for p in tables.paths for a in p)
    assert top < tables.live <= tables.m_nodes <= 2 * tables.p_prims
    assert tables.live % 2 == 1 or tables.live == tables.m_nodes
    assert tables.live <= top + 2


def _cube_stream(ta, r):
    """The merged t and entity attribute stream (numpy) of a 4x3x4 cuboid
    over the lamp, in front of the camera, for the rays `r`."""
    verts = np.zeros((64, 3, 3), np.float32)
    uv = np.zeros((64, 3, 2), np.float32)
    tex = np.zeros(64, np.int32)
    active = np.zeros(64, bool)
    cv, cu, ct = meshes.cuboid((8.0, 9.5, 8.0), (4.0, 3.0, 4.0))
    verts[:12], uv[:12], tex[:12], active[:12] = cv, cu, ct, True
    scene = ta._replace(
        tri_verts=torch.as_tensor(verts), tri_uv=torch.as_tensor(uv),
        tri_tex=torch.as_tensor(tex), tri_active=torch.as_tensor(active))
    t, tri_attrs = entity_attrs(
        scene, _tv3(r["o"]), _tv3(r["d"]), torch.as_tensor(r["pa"]),
        torch.as_tensor(r["t"]))
    return t.numpy(), tuple(a.numpy() for a in tri_attrs)


@pytest.mark.parametrize("nee_type", [0, 1])
def test_shade_with_tri_attrs_matches_jax(scenes, rays, nee_type):
    """A 4x3x4 cuboid over the lamp, in front of the camera: its hits
    reach both kernels as the same merged t and attribute stream."""
    _, ta = scenes
    r = rays
    t, tri_attrs = _cube_stream(ta, r)
    use_tri = (tri_attrs[11] >> 16) & 1
    assert 50 < use_tri.sum() < N // 2
    assert not use_tri[(r["d"] == 0).all(-1)].any()
    # entity hits also cover rays the voxel tracer missed
    assert (use_tri & ((r["pa"] & 1) == 0)).sum() > 10
    got, want = _both_shades(scenes, r, nee_type, 0, t=t,
                             tri_attrs=tri_attrs)
    _assert_shades_agree(got, want, nee_type)
    plain, _ = _both_shades(scenes, r, nee_type, 0)
    assert not torch.equal(got[3].x, plain[3].x) or not torch.equal(
        got[0].x, plain[0].x)


def _assert_shades_agree(got, want, nee_type):
    for name, gv, wv in zip(("origin", "direction", "throughput", "radiance"),
                            got, want):
        for c in range(3):
            g = gv[c].numpy()
            w = np.asarray(wv[c])
            assert np.all(np.isfinite(g)), name
            diff = np.abs(g - w) / np.maximum(1.0, np.abs(w))
            msg = f"{name}[{c}] nee {nee_type}"
            if nee_type == 0:
                assert diff.max() <= 1e-5, (msg, diff.max())
            else:
                assert diff.max() < 1e-3, (msg, diff.max())
                assert np.sqrt((diff ** 2).mean()) < 1e-5, msg


def _bf16_ulp(x):
    """The spacing of bfloat16 values at |x| (8 significant bits)."""
    _, e = np.frexp(np.abs(x).astype(np.float64))
    return np.ldexp(1.0, e - 8)


@pytest.mark.parametrize("nee_type,bounce,entity", [
    (0, 0, False), (1, 0, False), (2, 1, False), (1, 0, True)])
def test_shade_bf16_matches_jax(scenes, rays, nee_type, bounce, entity):
    """The bf16 color build (`color_bf16=True`) against the JAX kernel's.

    Bounds, with their reasons:
      * origin and direction (float32): the float32 bounds above;
      * tp (bfloat16 in and out, both): within 2 bfloat16 ulps of the JAX
        value (what comes out: equal);
      * radiance (float32): rad + tp * emission adds a bfloat16 product;
        XLA on the CPU may keep float32 across the fused emission product
        (EMISSION_SCALE * e * cos) where the port rounds after each op, as
        the kernel's per-op bfloat16 semantics do, so the added term may
        land an ulp of bfloat16 apart: within 2 bfloat16 ulps of the term,
        plus a float32 ulp of the sum."""
    _, ta = scenes
    r = rays
    t, tri_attrs = _cube_stream(ta, r) if entity else (None, None)
    got, want = _both_shades(scenes, r, nee_type, bounce, t=t,
                             tri_attrs=tri_attrs, color_bf16=True)
    _assert_shades_agree(got[:2], want[:2], nee_type)
    for c in range(3):
        g, w = got[2][c], want[2][c]
        assert g.dtype == torch.bfloat16 and w.dtype == jnp.bfloat16
        g, w = g.float().numpy(), np.asarray(w.astype(jnp.float32))
        assert np.all(np.isfinite(g))
        assert np.all(np.abs(g - w) <= 2 * _bf16_ulp(w)), c
        g, w = got[3][c].numpy(), np.asarray(want[3][c])
        assert got[3][c].dtype == torch.float32
        term = w - r["rad"][:, c]
        assert np.all(np.abs(g - w) <= 2 * _bf16_ulp(term)
                      + 1.2e-7 * np.maximum(1.0, np.abs(w))), c
    # the build is not the float32 one: tp rounds to bfloat16
    f32, _ = _both_shades(scenes, r, nee_type, bounce, t=t,
                          tri_attrs=tri_attrs)
    assert not torch.equal(got[2].x.float(), f32[2].x)


def _shading_points(n, seed):
    """Points on the config-1 terrain top (y = 5) and on the lamp's sides,
    with their face normals, plus directions toward the lamp."""
    g = np.random.default_rng(seed)
    p = np.stack([g.uniform(0, 16, n), np.full(n, 5.0015), g.uniform(0, 16, n)],
                 -1).astype(np.float32)
    nrm = np.tile(np.float32([0, 1, 0]), (n, 1))
    side = g.random(n) < 0.3
    p[side] = np.stack([np.full(side.sum(), 4.0), g.uniform(5, 8, side.sum()),
                        g.uniform(6, 9, side.sum())], -1)
    nrm[side] = [-1, 0, 0]
    target = np.stack([g.uniform(6, 9, n), g.uniform(5, 8, n),
                       g.uniform(6, 9, n)], -1).astype(np.float32)
    dirs = target - p
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return p, nrm, dirs.astype(np.float32)


def test_dense_sample_light_matches_jax(scenes):
    ja, ta = scenes
    p, nrm, _ = _shading_points(4096, 1)
    seeds = np.random.default_rng(2).integers(0, 2 ** 32, 4096,
                                              dtype=np.uint64)
    seeds = seeds.astype(np.uint32)
    active = np.random.default_rng(3).random(4096) < 0.8
    jsamp, jprobs = jwf.dense_sample_light(
        ja.lights, _jv3(p), _jv3(nrm),
        murmur3_combine(jnp.asarray(seeds), jnp.uint32(2)),
        jnp.asarray(active))
    tsamp, tprobs = twf.dense_sample_light(
        ta.lights, _tv3(p), _tv3(nrm),
        rng.combine(torch.as_tensor(seeds.astype(np.int64)), 2),
        torch.as_tensor(active))
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs),
                               rtol=1e-5, atol=1e-7)
    ok = np.asarray(jsamp.success)
    assert ok.sum() > 1000
    # a pick can flip only where the uniform lands within rounding of a
    # CDF step
    same = tsamp.success.numpy() == ok
    same &= tsamp.prim.numpy() == np.asarray(jsamp.prim)
    assert same.mean() > 0.999
    np.testing.assert_allclose(tsamp.probability.numpy()[same],
                               np.asarray(jsamp.probability)[same],
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tsamp.importance.numpy()[same],
                               np.asarray(jsamp.importance)[same],
                               rtol=1e-5, atol=1e-7)


def test_dense_nee_pdf_sweep_matches_jax(scenes):
    ja, ta = scenes
    p, nrm, dirs = _shading_points(4096, 4)
    mis = np.where(np.random.default_rng(5).random(4096) < 0.9, 0.3,
                   0.0).astype(np.float32)
    _, jprobs = jwf.dense_sample_light(
        ja.lights, _jv3(p), _jv3(nrm), jnp.zeros(4096, jnp.uint32),
        jnp.ones(4096, bool))
    want = np.asarray(jwf.nee_pdf_sweep(
        ja.lights, _jv3(p), _jv3(nrm), _jv3(dirs), jnp.asarray(mis), 32,
        dense_probs=jprobs))
    tprobs = twf.dense_prim_probs(ta.lights, _tv3(p), _tv3(nrm))
    got = twf.nee_pdf_sweep(ta.lights, _tv3(p), _tv3(nrm), _tv3(dirs),
                            torch.as_tensor(mis), tprobs).numpy()
    assert (want > 0).sum() > 1000
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_shade_caps_raise(scenes):
    """Past the kernel's light-table caps the shade raises (no fallback),
    as it does for a malformed entity stream; the bf16 color build runs
    and returns tp in bfloat16."""
    _, ta = scenes
    tables = prep_shade_tables(ta.atlas_packed, ta.lights)
    big = tables._replace(nodes=torch.zeros((2 * MAX_NODES, 8)))
    v = V3(*(torch.zeros(4) for _ in range(3)))
    i = torch.zeros(4, dtype=torch.int32)
    args = (ta.grid_origin, v, v, i, i, v.x, v, v, i, 0, 0, 1)
    with pytest.raises(ValueError):
        shade_pass(big, *args, nee_type=1)
    with pytest.raises(ValueError):
        shade_pass(tables._replace(dense=False), *args, nee_type=1)
    with pytest.raises(ValueError):
        shade_pass(tables, *args, nee_type=0, tri_attrs=())
    tp = shade_pass(tables, *args, nee_type=0, color_bf16=True)[2]
    assert all(c.dtype == torch.bfloat16 for c in tp)

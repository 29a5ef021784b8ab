"""The port's dynamic entities against the JAX package's.

`triangle_sweep` (closest hit over the entity triangle pool) runs on the
same triangles and rays in both packages: the winning triangle is equal,
and t and the barycentrics agree within 1e-6 on at least 99% of the hits
and within 1e-5 on all (both do the same float32 Moller-Trumbore; the
frameworks may contract a multiply-add differently, and a grazing ray
divides that rounding by a small determinant).
The port's `VoxelScene` with `add_object` / `update_object` /
`remove_object` must hold the same pool and build the same light set as
the JAX scene, an emissive cube's 12 triangle lights included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavefront_tpu.core import morton as jax_morton
from wavefront_tpu.render.intersect import triangle_sweep as jax_sweep
from wavefront_tpu.render.scene import VoxelScene as JaxVoxelScene
from wavefront_tpu.world import meshes as jax_meshes
from wavefront_tpu.world.blocks import BlockRegistry as JaxBlockRegistry
from wavefront_tpu_torch.core import morton
from wavefront_tpu_torch.core.vec3 import V3
from wavefront_tpu_torch.headline import config1_grid
from wavefront_tpu_torch.render import intersect
from wavefront_tpu_torch.render.intersect import triangle_sweep
from wavefront_tpu_torch.render.scene import VoxelScene
from wavefront_tpu_torch.world import meshes
from wavefront_tpu_torch.world.blocks import BlockRegistry


def test_cube_mesh_matches_jax():
    for args in (((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), 6),
                 ((4.0, 4.5, -2.0), (1.0, 2.0, 0.5), 18)):
        for got, want in zip(meshes.cuboid(*args), jax_meshes.cuboid(*args)):
            np.testing.assert_array_equal(got, want)
    for got, want in zip(meshes.unitcube(), jax_meshes.unitcube()):
        np.testing.assert_array_equal(got, want)


def test_deinterleave_bits_matches_jax():
    z = np.random.default_rng(0).integers(0, 2 ** 32, 4096, dtype=np.uint64)
    z = np.concatenate([z, [0, 1, 2, 3, 2 ** 32 - 1]]).astype(np.uint32)
    wi, wj = jax_morton.deinterleave_bits_2(jnp.asarray(z))
    gi, gj = morton.deinterleave_bits_2(torch.as_tensor(z.astype(np.int64)))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gj.numpy(), np.asarray(wj))
    ij = np.asarray(jax_morton.interleave_bits_2(wi, wj))
    np.testing.assert_array_equal(ij, z)


def _pool(seed=0, cap=64):
    """Two cubes and a slab in a 64-triangle pool, the rest inactive."""
    verts = np.zeros((cap, 3, 3), np.float32)
    active = np.zeros(cap, bool)
    k = 0
    for loc, dims in (((7.0, 6.5, 4.0), (1.0, 1.0, 1.0)),
                      ((9.5, 7.0, 9.0), (2.0, 0.5, 1.5)),
                      ((4.0, 9.0, 11.0), (3.0, 0.1, 3.0))):
        v, _, _ = meshes.cuboid(loc, dims)
        verts[k:k + 12] = v
        active[k:k + 12] = True
        k += 12
    # an inactive triangle in front of everything must never win
    verts[40] = [[0, 0, 0], [16, 0, 0], [0, 16, 16]]
    return verts, active


def _rays(n, seed):
    g = np.random.default_rng(seed)
    o = g.uniform((0, 5, 0), (16, 14, 16), (n, 3)).astype(np.float32)
    # aimed at (and a little around) the three meshes of _pool
    loc = np.float32([(7.0, 6.5, 4.0), (9.5, 7.0, 9.0), (4.0, 9.0, 11.0)])
    dims = np.float32([(1.0, 1.0, 1.0), (2.0, 0.5, 1.5), (3.0, 0.1, 3.0)])
    pick = g.integers(0, 3, n)
    target = loc[pick] + dims[pick] * g.uniform(-0.8, 0.8, (n, 3))
    d = (target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[g.random(n) < 0.1] = 0.0
    return o, d


def _tv3(a):
    return V3(*(torch.as_tensor(np.ascontiguousarray(a[:, i]))
                for i in range(3)))


def test_triangle_sweep_matches_jax(monkeypatch):
    verts, active = _pool()
    o, d = _rays(6000, 1)
    want = jax_sweep(jnp.asarray(verts), jnp.asarray(active), jnp.asarray(o),
                     jnp.asarray(d))
    tv, ta = torch.as_tensor(verts), torch.as_tensor(active)
    got = triangle_sweep(tv, ta, _tv3(o), _tv3(d))
    hit = np.asarray(want.hit)
    assert 1000 < hit.sum() < 5500
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    assert not got.hit.numpy()[(d == 0).all(-1)].any()
    assert set(np.unique(got.tri.numpy()[hit])) <= set(range(36))
    for f in ("t", "bary_u", "bary_v"):
        g = getattr(got, f).numpy()[hit]
        w = np.asarray(getattr(want, f))[hit]
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=f)
        assert np.isclose(g, w, rtol=1e-6, atol=1e-6).mean() > 0.99, f
    assert bool((got.t[~got.hit] == intersect.INF_T).all())
    # per-ray results do not depend on the ray chunk
    monkeypatch.setattr(intersect, "TRI_RAY_CHUNK", 1000)
    for a, b in zip(triangle_sweep(tv, ta, _tv3(o), _tv3(d)), got):
        assert torch.equal(a, b)


def _same_arrays(port_scene, jax_scene):
    pa, ja = port_scene.get_arrays(), jax_scene.get_arrays()
    for f in ("tri_verts", "tri_uv", "tri_tex", "tri_active"):
        np.testing.assert_array_equal(getattr(pa, f).numpy(),
                                      np.asarray(getattr(ja, f)), err_msg=f)
    assert pa.lights.num_prims == int(ja.lights.num_prims)
    assert pa.lights.dense == ja.lights.dense
    for f in pa.lights._fields:
        if f != "num_prims":
            a = getattr(pa.lights, f).numpy()
            np.testing.assert_array_equal(
                a, np.asarray(getattr(ja.lights, f)).astype(a.dtype),
                err_msg=f)
    return pa


@pytest.fixture()
def scenes():
    reg, jreg = BlockRegistry.load("assets"), JaxBlockRegistry.load("assets")
    grid = config1_grid(reg)
    return (VoxelScene(reg, grid, (0, 0, 0), max_light_prims=256,
                       device="cpu"),
            JaxVoxelScene(jreg, grid, (0, 0, 0), max_light_prims=256), reg)


def test_scene_entities_match_jax(scenes):
    """add / update / remove keep the pool and the light set equal to the
    JAX scene's; a move replaces only the pool."""
    port, jax_scene, reg = scenes
    empty = _same_arrays(port, jax_scene)
    assert empty.tri_verts.shape == (64, 3, 3) and not empty.tri_active.any()
    cube = meshes.unitcube()
    slab = meshes.cuboid((0.0, 0.0, 0.0), (2.0, 0.25, 2.0),
                         tex_offset=reg.block_idx("stone") * 6)
    move = np.float32([[1, 0, 0, 7.0], [0, 1, 0, 6.5], [0, 0, 1, 4.0]])
    for s in (port, jax_scene):
        s.add_object("ego", *cube, transform=move)
        s.add_object("a-slab", *slab)
    before = _same_arrays(port, jax_scene)
    assert int(before.tri_active.sum()) == 24
    # key order: "a-slab" fills the pool before "ego"
    np.testing.assert_array_equal(before.tri_tex[:12].numpy(), slab[2])
    np.testing.assert_allclose(before.tri_verts[12:24].numpy(),
                               cube[0] + move[:, 3])
    turn = np.float32([[0, 0, 1, 9.0], [0, 1, 0, 7.0], [-1, 0, 0, 5.0]])
    for s in (port, jax_scene):
        s.update_object("ego", turn)
    after = _same_arrays(port, jax_scene)
    assert after.grid is before.grid and after.lights is before.lights
    assert not torch.equal(after.tri_verts, before.tri_verts)
    for s in (port, jax_scene):
        s.remove_object("a-slab")
        s.remove_object("not there")
    assert int(_same_arrays(port, jax_scene).tri_active.sum()) == 12


def test_emissive_entity_becomes_lights(scenes):
    """A cube textured as a lamp adds 12 triangle lights, and moving it
    moves them (tests/test_lights.py's emissive cube, on a lit scene)."""
    port, jax_scene, reg = scenes
    lamp = reg.block_idx("lamp")
    glow = meshes.cuboid((4.0, 9.0, 4.0), (1.0, 1.0, 1.0),
                         tex_offset=lamp * 6)
    voxel_prims = port.get_arrays().lights.num_prims
    for s in (port, jax_scene):
        s.add_object("glow", *glow)
    a = _same_arrays(port, jax_scene)
    p = a.lights.num_prims
    assert p == voxel_prims + 12
    assert bool(a.lights.is_tri[p - 12:p].all())
    assert not bool(a.lights.is_tri[:p - 12].any())
    np.testing.assert_allclose(a.lights.power[p - 12:p].numpy(),
                               reg.luminance[lamp * 6] * 0.5, rtol=1e-5)
    shift = np.float32([[1, 0, 0, 3.0], [0, 1, 0, 0.0], [0, 0, 1, -1.0]])
    for s in (port, jax_scene):
        s.update_object("glow", shift)
    b = _same_arrays(port, jax_scene)
    assert b.lights is not a.lights
    np.testing.assert_allclose(
        b.lights.p0[p - 12:p].numpy(),
        a.lights.p0[p - 12:p].numpy() + shift[:, 3], atol=1e-6)


def test_entity_budget_raises(scenes):
    port, _, _ = scenes
    small = VoxelScene(port.registry, port.grid, (0, 0, 0),
                       max_entity_tris=16, device="cpu")
    small.add_object("one", *meshes.unitcube())
    small.get_arrays()
    small.add_object("two", *meshes.unitcube())
    with pytest.raises(ValueError):
        small.get_arrays()

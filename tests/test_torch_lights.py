"""The port's sparse light path against the JAX package's.

Light sets past the dense threshold are sampled by a stochastic BVH
descent (`traverse_light_bvh`) and their NEE pdf is summed by the slot
sweep and the reverse walk (`nee_pdf_sweep` without dense probabilities,
`reverse_walk_prob`).  Both packages get the same light set, built with
`dense_threshold` forced low so that it is sparse, and the same points,
normals, directions and murmur3 seeds, made with numpy.

Tolerances: the picked prim and the overflow count are equal;
probabilities, importances and pdfs agree within rtol 1e-5 (the two
frameworks may contract a multiply-add differently).  A descent can step
the other way only where its uniform lands within rounding of a branch
probability, so at most 0.1% of the picks may differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavefront_tpu.core.vec3 import V3 as JV3
from wavefront_tpu.render import lights as jax_lights
from wavefront_tpu.render import wavefront as jwf
from wavefront_tpu.render.scene import _light_arrays as jax_light_arrays
from wavefront_tpu.world.blocks import BlockRegistry as JaxBlockRegistry
from wavefront_tpu_torch.core.vec3 import V3
from wavefront_tpu_torch.render import lights as port_lights
from wavefront_tpu_torch.render import wavefront as twf
from wavefront_tpu_torch.render.scene import light_arrays
from wavefront_tpu_torch.world.blocks import BlockRegistry

N = 4096


def lamp_grid(registry):
    """A 24x12x24 room: a stone floor and 20 isolated lamp voxels (120 face
    prims) at seeded positions above it."""
    g = np.random.default_rng(7)
    grid = np.full((24, 12, 24), registry.air, np.uint8)
    grid[:, :2, :] = registry.block_idx("stone")
    cells = set()
    while len(cells) < 20:
        x, z = (int(c) for c in g.integers(1, 23, 2))
        y = int(g.integers(4, 11))
        if not any(abs(x - a) <= 1 and abs(y - b) <= 1 and abs(z - c) <= 1
                   for a, b, c in cells):
            cells.add((x, y, z))
    for c in cells:
        grid[c] = registry.block_idx("lamp")
    return grid


@pytest.fixture(scope="module")
def sparse_lights():
    """(JAX LightArrays, port LightArrays) of one sparse light set; the
    port's own light-set build makes the JAX package's arrays."""
    grid = lamp_grid(BlockRegistry.load("assets"))
    sets = []
    for mod, reg in ((jax_lights, JaxBlockRegistry.load("assets")),
                     (port_lights, BlockRegistry.load("assets"))):
        p0, e1, e2, power = mod.extract_voxel_lights(
            grid, np.zeros(3), reg)[:4]
        sets.append(mod.build_light_set(
            p0, e1, e2, power, np.zeros(len(p0), bool), 1024,
            dense_threshold=8))
    jls, pls = sets
    assert jls.num_prims == pls.num_prims == 120
    for f in ("p0", "e1", "e2", "power", "leaf_node", "node_left",
              "node_right", "node_parent", "node_min", "node_max",
              "node_power"):
        np.testing.assert_array_equal(getattr(jls, f), getattr(pls, f), f)
    ja, ta = jax_light_arrays(jls), light_arrays(pls, "cpu")
    assert not ja.dense and not ta.dense
    return ja, ta


def _jv3(a):
    return JV3(*(jnp.asarray(np.ascontiguousarray(a[:, i])) for i in range(3)))


def _tv3(a):
    return V3(*(torch.as_tensor(np.ascontiguousarray(a[:, i]))
                for i in range(3)))


def _points(seed):
    """Shading points on the floor top and on a wall, with their normals."""
    g = np.random.default_rng(seed)
    p = np.stack([g.uniform(0, 24, N), np.full(N, 2.0015),
                  g.uniform(0, 24, N)], -1).astype(np.float32)
    nrm = np.tile(np.float32([0, 1, 0]), (N, 1))
    wall = g.random(N) < 0.25
    p[wall, 0] = 0.0015
    p[wall, 1] = g.uniform(2, 12, wall.sum())
    nrm[wall] = [1, 0, 0]
    return p, nrm


def test_traverse_light_bvh_matches_jax(sparse_lights):
    ja, ta = sparse_lights
    p, nrm = _points(1)
    seeds = np.random.default_rng(2).integers(
        0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32)
    active = np.random.default_rng(3).random(N) < 0.85
    want = jwf.traverse_light_bvh(ja, _jv3(p), _jv3(nrm), jnp.asarray(seeds),
                                  jnp.asarray(active), 32)
    got = twf.traverse_light_bvh(
        ta, _tv3(p), _tv3(nrm), torch.as_tensor(seeds.astype(np.int64)),
        torch.as_tensor(active), 32)
    ok = np.asarray(want.success)
    assert ok.sum() > N // 2 and not ok[~active].any()
    np.testing.assert_array_equal(got.success.numpy(), ok)
    same = got.prim.numpy() == np.asarray(want.prim)
    assert same.mean() > 0.999
    assert len(np.unique(got.prim.numpy()[ok])) > 30
    for f in ("probability", "importance"):
        np.testing.assert_allclose(
            getattr(got, f).numpy()[same], np.asarray(getattr(want, f))[same],
            rtol=1e-5, atol=1e-30, err_msg=f)


def test_reverse_walk_prob_matches_jax(sparse_lights):
    ja, ta = sparse_lights
    p, nrm = _points(4)
    g = np.random.default_rng(5)
    leaf = np.asarray(ja.leaf_node)[g.integers(0, 120, N)]
    active = g.random(N) < 0.9
    want = np.asarray(jwf.reverse_walk_prob(
        ja, _jv3(p), _jv3(nrm), jnp.asarray(leaf), jnp.asarray(active), 32))
    got = twf.reverse_walk_prob(
        ta, _tv3(p), _tv3(nrm), torch.as_tensor(leaf.astype(np.int64)),
        torch.as_tensor(active), 32).numpy()
    assert (want > 0).sum() > N // 4 and not want[~active].any()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-30)


def test_descent_and_reverse_walk_agree(sparse_lights):
    """The reverse walk rebuilds the probability of the prim the descent
    picked (they differ only by the two epsilons of the corner test)."""
    _, ta = sparse_lights
    p, nrm = _points(6)
    seeds = torch.arange(N, dtype=torch.int64) * 2654435761 % 2 ** 32
    samp = twf.traverse_light_bvh(ta, _tv3(p), _tv3(nrm), seeds,
                                  torch.ones(N, dtype=torch.bool), 32)
    back = twf.reverse_walk_prob(ta, _tv3(p), _tv3(nrm),
                                 ta.leaf_node[samp.prim], samp.success, 32)
    ok = samp.success.numpy()
    close = np.isclose(back.numpy()[ok], samp.probability.numpy()[ok],
                       rtol=1e-4)
    assert close.mean() > 0.99


def _lamp_row_lights():
    """12 unit quads stacked along +z: a ray up the stack crosses all."""
    k = 12
    p0 = np.array([[-0.5, -0.5, 2.0 + i] for i in range(k)], np.float32)
    e1 = np.tile(np.float32([[1, 0, 0]]), (k, 1))
    e2 = np.tile(np.float32([[0, 1, 0]]), (k, 1))
    args = (p0, e1, e2, np.full(k, 5.0, np.float32), np.zeros(k, bool), 64)
    return (jax_light_arrays(jax_lights.build_light_set(
                *args, dense_threshold=8)),
            light_arrays(port_lights.build_light_set(
                *args, dense_threshold=8), "cpu"))


@pytest.mark.parametrize("max_hits", [2, 8])
def test_sparse_nee_pdf_sweep_matches_jax(sparse_lights, max_hits):
    """The sparse sweep on the lamp room (rays aimed at lamps) and on a
    stack of 12 quads, where rays up the stack overflow the slots."""
    for (ja, ta), aim in ((sparse_lights, "lamps"),
                          (_lamp_row_lights(), "stack")):
        g = np.random.default_rng(8)
        if aim == "lamps":
            p, nrm = _points(9)
            prim = g.integers(0, 120, N)
            target = (np.asarray(ja.p0)[prim]
                      + 0.5 * np.asarray(ja.e1)[prim]
                      + 0.5 * np.asarray(ja.e2)[prim])
        else:
            p = np.stack([g.uniform(-0.4, 0.4, N), g.uniform(-0.4, 0.4, N),
                          np.zeros(N)], -1).astype(np.float32)
            nrm = np.tile(np.float32([0, 0, 1]), (N, 1))
            target = p + np.float32([0, 0, 20]) + g.normal(0, 0.6, (N, 3))
        d = (target - p).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        d[g.random(N) < 0.05] = 0.0
        mis = np.where(g.random(N) < 0.9, 0.3, 0.0).astype(np.float32)
        want, want_ovf = jwf.nee_pdf_sweep(
            ja, _jv3(p), _jv3(nrm), _jv3(d), jnp.asarray(mis), 32,
            max_hits=max_hits, with_overflow=True)
        got, ovf = twf.nee_pdf_sweep(
            ta, _tv3(p), _tv3(nrm), _tv3(d), torch.as_tensor(mis), None,
            max_depth=32, max_hits=max_hits, with_overflow=True)
        want = np.asarray(want)
        assert (want > 0).sum() > N // 4, aim
        assert ovf == int(want_ovf), aim
        if aim == "stack":
            assert ovf > N // 4
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-30,
                                   err_msg=aim)
        # without the audit the pdf alone comes back
        alone = twf.nee_pdf_sweep(
            ta, _tv3(p), _tv3(nrm), _tv3(d), torch.as_tensor(mis), None,
            max_depth=32, max_hits=max_hits)
        assert torch.equal(alone, got)


def test_sparse_sweep_does_not_depend_on_the_ray_chunk(sparse_lights,
                                                       monkeypatch):
    _, ta = sparse_lights
    p, nrm = _points(10)
    prim = np.random.default_rng(11).integers(0, 120, N)
    target = (ta.p0.numpy()[prim] + 0.5 * ta.e1.numpy()[prim]
              + 0.5 * ta.e2.numpy()[prim])
    d = (target - p).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    mis = torch.full((N,), 0.3)
    args = (ta, _tv3(p), _tv3(nrm), _tv3(d), mis, None)
    whole = twf.nee_pdf_sweep(*args)
    monkeypatch.setattr(twf, "RAY_CHUNK", 1000)
    assert torch.equal(twf.nee_pdf_sweep(*args), whole)

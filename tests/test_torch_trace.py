"""The port's tracer against the JAX package's XLA DDA.

`wavefront_tpu_torch.kernels.window_trace.window_trace` takes its plain
version (`render.intersect.trace_plain`) for CPU tensors; that plain
version is what the CUDA tracer is held to on the card (the `cuda`
tests).
Here it runs against `wavefront_tpu.render.intersect.dda_trace`
(max_steps=512) on the fixture grids of tests/test_window_trace.py: the
skipping march (the scene's aux grid) against `dda_trace(aux_grid=...)`,
and the unskipped march (the same aux grid with its distances at 0)
against `dda_trace` without one.  The packed hit words must be equal on
every ray (hit, entered, face, voxel and owner; misses carry owner 255 in
both), and `t` must agree within 2e-4 on hits, the bound of
tests/test_window_trace.py; the two marches must give the same words.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavefront_tpu.kernels.shade import pack_hits as jax_pack_hits
from wavefront_tpu.kernels.window_trace import (
    _coherence_key as jax_coherence_key,
    _unpack_hits as jax_unpack_hits,
    auto_events as jax_auto_events,
)
from wavefront_tpu.render.intersect import VoxelHit as JaxVoxelHit
from wavefront_tpu.render.intersect import dda_trace
from wavefront_tpu.render.intersect import make_aux_grid as jax_make_aux_grid
from wavefront_tpu_torch.core.vec3 import V3
from wavefront_tpu_torch.kernels.window_trace import (
    auto_events,
    coherence_key,
    window_trace,
)
from wavefront_tpu_torch.render.intersect import (
    VoxelHit,
    make_aux_grid,
    pack_hits,
    truncated,
    unpack_hits,
)

T_ATOL = 2e-4
FIELDS = ("hit", "owner", "face", "vx", "vy", "vz", "entered")


def _tables(num_blocks=4):
    transparent = np.zeros(256, bool)
    translucent = np.zeros(256, bool)
    transparent[0] = translucent[0] = True          # air
    translucent[2] = True                           # block 2: glass
    transparent[num_blocks:] = True                 # beyond-table = air
    translucent[num_blocks:] = True
    return transparent, translucent


def _scene(grid, origin_world=(0, 0, 0), num_blocks=4, skip=True):
    """The tracer's scene fields; skip=False zeroes the aux grid's
    distances (the unskipped march)."""
    transparent, translucent = _tables(num_blocks)
    aux = make_aux_grid(grid, transparent, translucent)
    return types.SimpleNamespace(
        grid=torch.as_tensor(grid), grid_origin=tuple(origin_world),
        aux_grid=torch.as_tensor(aux if skip else aux & 3))


def _v3(a):
    return V3.from_array(torch.as_tensor(np.asarray(a, np.float32)))


def _compare(grid, o, d, origin_world=(0, 0, 0), num_blocks=4):
    transparent, translucent = _tables(num_blocks)
    budget = auto_events(*grid.shape)
    words = []
    for aux in (jax_make_aux_grid(grid, transparent, translucent), None):
        scene = _scene(grid, origin_world, num_blocks, skip=aux is not None)
        pa, pb, t = window_trace(scene, _v3(o), _v3(d), budget)
        assert not bool(truncated(pa).any()), "rays exhausted the budget"
        got = unpack_hits(pa, pb, t)
        words.append((pa, pb, t))
        ref = dda_trace(
            jnp.asarray(grid), jnp.asarray(origin_world, jnp.int32),
            jnp.asarray(transparent), jnp.asarray(translucent), 255,
            jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32),
            max_steps=512,
            aux_grid=None if aux is None else jnp.asarray(aux),
        )
        rpa, rpb, rt = (np.asarray(x) for x in jax_pack_hits(ref))
        hit = np.asarray(ref.hit)
        for f in FIELDS:
            want = np.asarray(getattr(ref, f))
            np.testing.assert_array_equal(
                getattr(got, f).numpy()[hit], want[hit], err_msg=f)
        np.testing.assert_array_equal(got.hit.numpy(), hit)
        np.testing.assert_array_equal(pa.numpy(), rpa)
        np.testing.assert_array_equal(pb.numpy(), rpb)
        np.testing.assert_allclose(t.numpy()[hit], rt[hit], rtol=0,
                                   atol=T_ATOL)
        np.testing.assert_array_equal(t.numpy()[~hit], rt[~hit])
    for skipped, unskipped in zip(*words):
        np.testing.assert_array_equal(skipped.numpy(), unskipped.numpy())
    return got


def _ray_fan(center, n, seed):
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.tile(np.asarray(center, np.float32), (n, 1))
    return o, d


def _random_rays(rng, n, lo, hi):
    o = (rng.random((n, 3)) * (np.asarray(hi) - np.asarray(lo))
         + np.asarray(lo)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _single_block():
    grid = np.zeros((8, 8, 8), np.uint8)
    grid[4, 3, 4] = 1
    o, d = _ray_fan((4.5, 6.5, 4.5), 64, 0)
    d[0] = [0.0, -1.0, 0.0]          # straight down onto the block
    d[1] = [0.1, -0.99, -0.1]
    return grid, o, d


def _terrain():
    rng = np.random.default_rng(1)
    grid = np.zeros((16, 16, 16), np.uint8)
    h = (4 + 4 * rng.random((16, 16))).astype(int)
    for x in range(16):
        for z in range(16):
            grid[x, : h[x, z], z] = 1
    return (grid, *_ray_fan((8.0, 12.0, 8.0), 256, 2))


def _glass_outside_origins():
    rng = np.random.default_rng(3)
    grid = np.zeros((12, 8, 12), np.uint8)
    grid[2:10, 0:3, 2:10] = 1
    grid[5, 3, 5] = 2       # glass on top
    grid[6, 3, 5] = 1
    return (grid, *_random_rays(rng, 256, (-9, -9, -9), (21, 21, 21)))


def _axis_rays():
    grid = np.zeros((6, 6, 6), np.uint8)
    grid[0, 2, 2] = 1          # solid at the -x border
    grid[5, 2, 3] = 1          # solid at the +x border
    grid[:, 0, :] = 1          # floor at the grid bottom
    grid[2, 5, 2] = 1          # solid at the very top
    o = np.array([
        [0.5, 2.5, 2.5], [5.5, 2.5, 3.5], [-3.0, 2.5, 2.5], [9.0, 2.5, 3.5],
        [2.5, 4.5, 2.5], [2.5, 1.5, 2.5], [2.5, 0.5, 2.5], [2.5, 5.5, 2.5],
    ], np.float32)
    d = np.array([
        [-1, 0, 0], [1, 0, 0], [1, 0, 0], [-1, 0, 0],
        [0, -1, 0], [0, 1, 0], [0, -1, 0], [0, 1, 0],
    ], np.float32)
    return grid, o, d


def _slab_boundaries():
    grid = np.zeros((8, 70, 8), np.uint8)
    grid[2, 28:40, 2] = 1      # solid column through y=32
    grid[4, 31, 4] = 1         # face at y=32, air above
    grid[5, 32, 5] = 1         # face at y=32, air below
    grid[3, 31, 3] = 1
    grid[3, 32, 3] = 2         # glass right above solid at the boundary
    grid[6, 63, 6] = 1
    grid[6, 64, 6] = 1         # spanning y=64
    o = np.array([
        [2.5, 50.0, 2.5], [2.5, 10.0, 2.5], [4.5, 50.0, 4.5],
        [5.5, 10.0, 5.5], [3.5, 50.0, 3.5], [3.5, 10.0, 3.5],
        [6.5, 50.0, 6.5], [2.5, 34.0, 2.5], [2.5, 30.0, 2.5],
    ], np.float32)
    d = np.array([[0, -1, 0], [0, 1, 0]] * 4 + [[0, -1, 0]], np.float32)
    o2, d2 = _ray_fan((4.0, 36.0, 4.0), 96, 31)
    return grid, np.concatenate([o, o2]), np.concatenate([d, d2])


def _window_boundaries():
    grid = np.zeros((48, 8, 48), np.uint8)
    grid[28:40, 2, 28:40] = 1       # plate across x=32 and z=32
    grid[31, 4, 10] = 1
    grid[32, 4, 11] = 1
    grid[10, 4, 31] = 1
    grid[10, 4, 32] = 2             # glass just across the z boundary
    o = np.array([
        [20.0, 2.5, 34.5], [45.0, 2.5, 34.5], [20.0, 4.5, 10.5],
        [45.0, 4.5, 11.5], [10.5, 4.5, 20.0], [10.5, 4.5, 45.0],
        [34.5, 6.0, 34.5],
    ], np.float32)
    d = np.array([
        [1, 0, 0], [-1, 0, 0], [1, 0, 0], [-1, 0, 0],
        [0, 0, 1], [0, 0, -1], [0, -1, 0],
    ], np.float32)
    o2, d2 = _ray_fan((32.0, 4.0, 32.0), 128, 41)
    return grid, np.concatenate([o, o2]), np.concatenate([d, d2])


def _grazing_terrain():
    rng = np.random.default_rng(21)
    gx, gy, gz = 48, 24, 48
    grid = np.zeros((gx, gy, gz), np.uint8)
    h = (8 + 5 * np.sin(np.arange(gx)[:, None] / 5.0)
         * np.cos(np.arange(gz)[None, :] / 7.0)
         + 2 * rng.random((gx, gz))).astype(int)
    for x in range(gx):
        for z in range(gz):
            grid[x, : max(h[x, z], 1), z] = 1
    n = 192
    o = np.tile(np.asarray([24.0, 18.0, 24.0], np.float32), (n, 1))
    ang = rng.random(n) * 2 * np.pi
    dy = -0.05 - 0.3 * rng.random(n)
    d = np.stack([np.cos(ang), dy, np.sin(ang)], -1).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return grid, o, d


def _corner_ties():
    """Lattice-diagonal rays from voxel centers: their crossing times tie
    exactly at every step, so the x-before-y-before-z order decides which
    voxel (and face) a ray meets first."""
    rng = np.random.default_rng(17)
    grid = (rng.random((12, 12, 12)) < 0.2).astype(np.uint8)
    grid[(rng.random((12, 12, 12)) < 0.05) & (grid == 0)] = 2
    dirs = np.array([(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1)
                     for k in (-1, 0, 1) if (i, j, k) != (0, 0, 0)],
                    np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    cells = rng.integers(0, 12, (24, 3)).astype(np.float32) + 0.5
    o = np.repeat(cells, len(dirs), axis=0)
    d = np.tile(dirs, (len(cells), 1))
    return grid, o, d


CASES = {
    "corner_ties": _corner_ties,
    "single_block": _single_block,
    "terrain": _terrain,
    "glass_outside_origins": _glass_outside_origins,
    "axis_rays": _axis_rays,
    "slab_boundaries": _slab_boundaries,
    "window_boundaries": _window_boundaries,
    "grazing_terrain": _grazing_terrain,
}


def _worldgen_tables():
    """A reduced worldgen grid (3x1x3 chunks) and the 256-entry tables the
    port's scene builds for it."""
    from wavefront_tpu_torch.core.config import WorldSettings
    from wavefront_tpu_torch.headline import ASSETS, build_scene
    from wavefront_tpu_torch.world.blocks import BlockRegistry

    reg = BlockRegistry.load(ASSETS)
    grid, _ = build_scene(reg, WorldSettings(), span=1)
    nb = reg.num_blocks
    transparent, translucent = np.ones(256, bool), np.ones(256, bool)
    transparent[: nb + 1] = reg.transparent
    translucent[: nb + 1] = reg.translucent
    return grid, transparent, translucent


@pytest.mark.parametrize("case", sorted(CASES) + ["worldgen"])
def test_make_aux_grid_matches_jax(case):
    """The port's aux grid holds the JAX package's values, as uint8."""
    if case == "worldgen":
        grid, transparent, translucent = _worldgen_tables()
    else:
        grid = CASES[case]()[0]
        transparent, translucent = _tables()
    got = make_aux_grid(grid, transparent, translucent)
    want = jax_make_aux_grid(grid, transparent, translucent)
    assert got.dtype == np.uint8 and want.max() < 128
    np.testing.assert_array_equal(got.astype(np.int32), want)
    assert (got >> 2).max() >= 2, "no voxel far enough from a solid to skip"


@pytest.mark.parametrize("case", sorted(CASES))
def test_trace_matches_jax_dda(case):
    grid, o, d = CASES[case]()
    got = _compare(grid, o, d)
    assert bool(got.hit.any())


def test_world_origin_offset():
    grid = np.zeros((8, 8, 8), np.uint8)
    grid[3:5, 2:4, 3:5] = 1
    o, d = _ray_fan((-60.5 + 4.0, 34.0 + 6.0, 100.5 + 4.0), 64, 11)
    got = _compare(grid, o, d, origin_world=(-60, 32, 100))
    assert bool(got.hit.any())


@pytest.mark.parametrize("trial", range(3))
def test_fuzz_grids(trial):
    rng = np.random.default_rng(7 + trial)
    gx, gy, gz = (int(v) for v in rng.integers(4, 20, 3))
    grid = (rng.random((gx, gy, gz)) < 0.15).astype(np.uint8)
    glass = (rng.random((gx, gy, gz)) < 0.05) & (grid == 0)
    grid[glass] = 2
    o, d = _random_rays(rng, 128, (-5, -5, -5), (gx + 5, gy + 5, gz + 5))
    d[:6] = [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
             [0, 0, -1]]
    d[6] = 0.0                  # an inactive ray
    got = _compare(grid, o, d, origin_world=(-gx // 2, 0, 3))
    assert not bool(got.hit[6])


def test_truncation_sets_bit_22():
    """A budget too small to finish reports misses with bit 22 set; a
    sufficient one hits everywhere with the bit clear."""
    grid = np.zeros((40, 8, 40), np.uint8)
    grid[:, 0, :] = 1
    grid[39, 1:, :] = 1                       # wall at far +x
    scene = _scene(grid)
    o = np.tile(np.asarray([0.5, 4.5, 20.2], np.float32), (64, 1))
    d = np.tile(np.asarray([1.0, 0.001, 0.013], np.float32), (64, 1))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pa, pb, t = window_trace(scene, _v3(o), _v3(d), 3)
    assert bool(truncated(pa).all())
    assert not bool(((pa & 1) != 0).any())
    pa, pb, t = window_trace(scene, _v3(o), _v3(d), 256)
    assert not bool(truncated(pa).any())
    assert bool(((pa & 1) != 0).all())


def test_pack_hits_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    n = 257
    fields = dict(
        hit=rng.integers(0, 2, n).astype(bool),
        t=rng.uniform(0, 100, n).astype(np.float32),
        owner=rng.integers(0, 256, n).astype(np.int32),
        face=rng.integers(0, 6, n).astype(np.int32),
        vx=rng.integers(-2, 1022, n).astype(np.int32),
        vy=rng.integers(-2, 510, n).astype(np.int32),
        vz=rng.integers(-2, 1022, n).astype(np.int32),
        entered=rng.integers(0, 2, n).astype(bool),
    )
    want = jax_pack_hits(JaxVoxelHit(**{k: jnp.asarray(v)
                                        for k, v in fields.items()}))
    got = pack_hits(VoxelHit(**{k: torch.as_tensor(v)
                                for k, v in fields.items()}))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    back = unpack_hits(*got)
    jback = jax_unpack_hits(*want)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(back, f).numpy(), fields[f])
        np.testing.assert_array_equal(getattr(back, f).numpy(),
                                      np.asarray(getattr(jback, f)))


@pytest.mark.parametrize("shape", [(160, 32, 160), (48, 70, 40)])
def test_coherence_key_matches_jax(shape):
    """The bounce-sort key equals the JAX key on at least 99.9% of rays
    (atan2 may round an ulp apart; the image does not depend on the key)."""
    rng = np.random.default_rng(5)
    n = 20000
    o = (rng.random((n, 3)) * (np.asarray(shape) + 40) - 20).astype(
        np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[: n // 10] = 0.0                        # dead rays sort last
    pack = types.SimpleNamespace(
        nwx=-(-shape[0] // 32), nky=-(-shape[1] // 32), nwz=-(-shape[2] // 32))
    want = np.asarray(jax_coherence_key(
        pack, *(jnp.asarray(c) for c in (*o.T, *d.T))))
    got = coherence_key(*(torch.as_tensor(np.ascontiguousarray(c))
                          for c in (*o.T, *d.T)), *shape)
    got = got.numpy()
    assert got.min() >= 0 and got.max() < 2 ** 32
    assert (got.astype(np.uint32) == want).mean() >= 0.999
    assert np.all(got[: n // 10] >> 31 == 1)
    assert np.all(got[n // 10:] >> 31 == 0)


@pytest.mark.parametrize("shape", [(160, 32, 160), (416, 96, 416),
                                   (8, 8, 8)])
def test_auto_events_matches_jax(shape):
    pack = types.SimpleNamespace(gx=shape[0], gy=shape[1], gz=shape[2])
    assert auto_events(*shape) == jax_auto_events(pack)


def test_grid_beyond_hit_words_raises():
    """vy+2 has 9 bits in the hit words: a grid taller than 507 rows is
    refused rather than packed wrong (the JAX pack refuses it too)."""
    tall = np.zeros((4, 520, 4), np.uint8)
    o, d = _ray_fan((2.0, 10.0, 2.0), 4, 0)
    with pytest.raises(ValueError):
        window_trace(_scene(tall), _v3(o), _v3(d), 64)

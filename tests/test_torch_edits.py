"""The port's scene edits against the JAX package (ladder config 4 and the
streamed window's recenter).

Held exactly: `refresh_aux_box`, `update_aux_region`, `recenter_boxes`
and `shift_refresh_aux` (the port's aux grid is uint8, the JAX one int32,
with equal values), and the grid and aux grid a `VoxelScene` keeps on the
host and on the device after block edits and window shifts, against
`make_aux_grid` of the edited grid and a from-scratch window.  Frames
after an edit are held to the JAX `Renderer` after the same edits within
max |diff| 1e-3 and RMS 1e-5 (tests/test_torch_render.py), and a
`cache_primary` frame after an edit to the uncached frame bit for bit.
"""

import numpy as np
import pytest

from wavefront_tpu.core.config import RenderingPreferences as JaxPrefs
from wavefront_tpu.core.config import RenderSettings as JaxSettings
from wavefront_tpu.core.config import WorldSettings as JaxWorldSettings
from wavefront_tpu.render import intersect as jax_intersect
from wavefront_tpu.render import scene as jax_scene
from wavefront_tpu.render.renderer import Renderer as JaxRenderer
from wavefront_tpu.render.scene import VoxelScene as JaxVoxelScene
from wavefront_tpu.world.blocks import BlockRegistry as JaxBlockRegistry
from wavefront_tpu.world.chunk_manager import ChunkManager as JaxChunkManager
from wavefront_tpu_torch.core.config import (
    RenderingPreferences,
    RenderSettings,
    WorldSettings,
)
from wavefront_tpu_torch.headline import config1_grid, config1_pose
from wavefront_tpu_torch.render import scene as scene_mod
from wavefront_tpu_torch.render.intersect import (
    make_aux_grid,
    refresh_aux_box,
    update_aux_region,
)
from wavefront_tpu_torch.render.renderer import Renderer
from wavefront_tpu_torch.render.scene import VoxelScene
from wavefront_tpu_torch.world import meshes
from wavefront_tpu_torch.world.blocks import BlockRegistry
from wavefront_tpu_torch.world.chunk_manager import ChunkManager
from wavefront_tpu_torch.world.game_world import translation
from wavefront_tpu_torch.world.worldgen import WorldGenerator

ASSETS = "assets"


@pytest.fixture(scope="module")
def registry():
    return BlockRegistry.load(ASSETS)


@pytest.fixture(scope="module")
def jax_registry():
    return JaxBlockRegistry.load(ASSETS)


def tables(registry):
    nb = registry.num_blocks
    transp = np.ones(256, bool)
    transl = np.ones(256, bool)
    transp[: nb + 1] = registry.transparent
    transl[: nb + 1] = registry.translucent
    return transp, transl


def random_grid(registry, rs, shape, fill=0.05):
    grid = np.full(shape, registry.air, np.uint8)
    ids = [registry.block_idx(n) for n in ("stone", "glass", "grass", "lamp")]
    m = rs.rand(*shape) < fill
    grid[m] = rs.choice(ids, int(m.sum()))
    return grid


def equal_aux(got, want):
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got.astype(np.int32), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_refresh_aux_box_matches_jax(registry, seed):
    transp, transl = tables(registry)
    rs = np.random.RandomState(seed)
    shape = (40, 24, 48)
    grid = random_grid(registry, rs, shape)
    aux = make_aux_grid(grid, transp, transl)
    jaux = jax_intersect.make_aux_grid(grid, transp, transl)
    equal_aux(aux, jaux)
    # the aux grid of an older grid, refreshed over a box of the new one
    new = random_grid(registry, rs, shape, fill=0.08)
    lo = rs.randint(0, 20, 3)
    hi = np.minimum(lo + rs.randint(1, 30, 3), shape)
    for max_skip in (31, 5):
        got = refresh_aux_box(new, aux, transp, transl, lo, hi,
                              max_skip=max_skip)
        want = jax_intersect.refresh_aux_box(new, jaux, transp, transl, lo,
                                             hi, max_skip=max_skip)
        equal_aux(got, want)
    # not in place: aux is unchanged; in place: aux is the result
    np.testing.assert_array_equal(aux, make_aux_grid(grid, transp, transl))
    out = refresh_aux_box(new, aux, transp, transl, lo, hi, in_place=True)
    assert out is aux


@pytest.mark.parametrize("seed", [0, 1])
def test_update_aux_region_matches_full_rebuild(registry, seed):
    """tests/test_incremental.py's test on the port, and each step against
    the JAX package's update_aux_region."""
    transp, transl = tables(registry)
    rs = np.random.RandomState(seed)
    grid = np.full((24, 24, 24), registry.air, np.uint8)
    grid[rs.rand(*grid.shape) < 0.05] = registry.block_idx("stone")
    aux = make_aux_grid(grid, transp, transl)
    jaux = jax_intersect.make_aux_grid(grid, transp, transl)
    for _ in range(4):
        p = rs.randint(0, 24, 3)
        new_block = rs.choice([registry.air, registry.block_idx("stone"),
                               registry.block_idx("glass")])
        grid = grid.copy()
        grid[tuple(p)] = new_block
        aux = update_aux_region(grid, aux, transp, transl, p)
        jaux = jax_intersect.update_aux_region(grid, jaux, transp, transl, p)
        np.testing.assert_array_equal(aux, make_aux_grid(grid, transp, transl))
        equal_aux(aux, jaux)


SHIFTS = [(8, 0, 0), (-8, 0, 8), (3, -2, 5), (0, 0, -40), (37, 0, 0)]


@pytest.mark.parametrize("delta", SHIFTS)
def test_recenter_boxes_and_shift_match_jax(registry, delta):
    transp, transl = tables(registry)
    rs = np.random.RandomState(sum(delta) + 50)
    shape = np.array((48, 24, 48))
    # one world, two windows on it: the old at (0,0,0), the new at delta
    world = random_grid(registry, rs, tuple(shape + 2 * 40), fill=0.03)
    base = np.array((40, 40, 40))
    old_grid = world[tuple(slice(b, b + s) for b, s in zip(base, shape))]
    nb = base + np.array(delta)
    grid = world[tuple(slice(b, b + s) for b, s in zip(nb, shape))].copy()
    changed = [(np.array((4, 2, 4)) + delta, np.array((12, 8, 12)) + delta),
               (np.array((0, 0, 0)) + delta, shape + delta)]
    new_origin = np.array(delta)
    got = scene_mod.recenter_boxes(delta, shape, changed[:1], new_origin)
    want = jax_scene.recenter_boxes(delta, shape, changed[:1], new_origin)
    assert len(got) == len(want)
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    for ch in (changed[:1], changed[1:], None):
        aux, dirty = scene_mod.shift_refresh_aux(
            make_aux_grid(old_grid, transp, transl), grid, transp, transl,
            np.array(delta), ch, new_origin)
        jaux, jdirty = jax_scene.shift_refresh_aux(
            jax_intersect.make_aux_grid(old_grid, transp, transl), grid,
            transp, transl, np.array(delta), ch, new_origin)
        equal_aux(aux, jaux)
        assert [tuple(map(tuple, b)) for b in dirty] == \
            [tuple(map(tuple, b)) for b in jdirty]
        # the shift is exact: the window's own aux grid, built afresh
        np.testing.assert_array_equal(aux, make_aux_grid(grid, transp,
                                                         transl))


def test_scene_set_block_keeps_device_arrays_in_sync(registry):
    """tests/test_incremental.py's test on the port: a glass edit keeps the
    light set object; an emissive edit rebuilds it; each edit gives new
    arrays and leaves the old ones as they were."""
    grid = np.full((16, 16, 16), registry.air, np.uint8)
    grid[:, :4, :] = registry.block_idx("stone")
    scene = VoxelScene(registry, grid, (0, 0, 0), max_light_prims=64,
                       device="cpu")
    a0 = scene.get_arrays()
    glass = registry.block_idx("glass")

    scene.set_block((8, 8, 8), glass)
    a1 = scene.get_arrays()
    assert a1 is not a0
    assert int(a1.grid[8, 8, 8]) == glass
    assert int(a0.grid[8, 8, 8]) == registry.air
    transp, transl = tables(registry)
    want_aux = make_aux_grid(a1.grid.numpy(), transp, transl)
    np.testing.assert_array_equal(a1.aux_grid.numpy(), want_aux)
    np.testing.assert_array_equal(scene._aux, want_aux)
    np.testing.assert_array_equal(a0.aux_grid.numpy(),
                                  make_aux_grid(grid, transp, transl))
    assert a1.lights is a0.lights

    scene.set_block((8, 10, 8), registry.block_idx("lamp"))
    a2 = scene.get_arrays()
    assert int(a2.lights.num_prims) > int(a0.lights.num_prims)
    np.testing.assert_array_equal(a2.grid.numpy(), scene.grid)
    np.testing.assert_array_equal(
        a2.aux_grid.numpy(), make_aux_grid(scene.grid, transp, transl))

    # outside the window nothing happens; get_block reads air there
    scene.set_block((8, 40, 8), glass)
    assert scene.get_arrays() is a2
    assert scene.get_block((8, 40, 8)) == registry.air
    assert scene.get_block((8, 10, 8)) == registry.block_idx("lamp")


def test_set_block_before_arrays_and_set_grid(registry, jax_registry):
    """Edits before the first get_arrays, and set_grid, build everything at
    the next get_arrays, as the JAX scene does."""
    transp, transl = tables(registry)
    grid = config1_grid(registry)
    scene = VoxelScene(registry, grid, (3, 0, -2), device="cpu")
    jscene = JaxVoxelScene(jax_registry, grid, (3, 0, -2))
    for s in (scene, jscene):
        s.set_block((5, 6, 1), registry.block_idx("stone"))
    np.testing.assert_array_equal(scene.grid, jscene.grid)
    a = scene.get_arrays()
    np.testing.assert_array_equal(a.grid.numpy(), jscene.grid)
    equal_aux(a.aux_grid.numpy(), np.asarray(jscene.get_arrays().aux_grid))
    rs = np.random.RandomState(3)
    other = random_grid(registry, rs, (16, 16, 16))
    scene.set_grid(other, (0, 0, 0))
    b = scene.get_arrays()
    assert b is not a and b.grid_origin == (0, 0, 0)
    np.testing.assert_array_equal(b.aux_grid.numpy(),
                                  make_aux_grid(other, transp, transl))


def test_update_object_incremental_matches_scratch(registry):
    """tests/test_incremental.py's test on the port: moving an entity keeps
    the grid; moving an emissive one rebuilds the light set as a fresh
    scene builds it."""
    grid = np.full((16, 16, 16), registry.air, np.uint8)
    grid[:, :4, :] = registry.block_idx("stone")
    verts, uv, tex = meshes.unitcube()
    lamp = registry.block_idx("lamp")
    lverts, luv, ltex = meshes.cuboid((4.0, 8.0, 4.0), (1.0, 1.0, 1.0),
                                      tex_offset=lamp * 6)

    def fresh(iso_cube, iso_glow=None):
        s = VoxelScene(registry, grid.copy(), (0, 0, 0), max_light_prims=64,
                       device="cpu")
        s.add_object("cube", verts, uv, tex, transform=iso_cube)
        s.add_object("glow", lverts, luv, ltex, transform=iso_glow)
        return s.get_arrays()

    iso0 = translation(4.0, 6.0, 4.0)[:3]
    iso1 = translation(7.0, 9.0, 5.0)[:3]
    scene = VoxelScene(registry, grid.copy(), (0, 0, 0), max_light_prims=64,
                       device="cpu")
    scene.add_object("cube", verts, uv, tex, transform=iso0)
    scene.add_object("glow", lverts, luv, ltex)
    a0 = scene.get_arrays()
    scene.update_object("cube", iso1)
    a1 = scene.get_arrays()
    assert a1.grid is a0.grid and a1.lights is a0.lights
    want = fresh(iso1)
    np.testing.assert_allclose(a1.tri_verts.numpy(), want.tri_verts.numpy(),
                               atol=1e-6)
    np.testing.assert_array_equal(a1.tri_active.numpy(),
                                  want.tri_active.numpy())

    iso_g = translation(2.0, 10.0, 2.0)[:3]
    scene.update_object("glow", iso_g)
    a2 = scene.get_arrays()
    assert a2.grid is a0.grid
    want2 = fresh(iso1, iso_g)
    p = int(want2.lights.num_prims)
    assert int(a2.lights.num_prims) == p
    np.testing.assert_allclose(a2.lights.p0[:p].numpy(),
                               want2.lights.p0[:p].numpy(), atol=1e-5)


def _fresh_window(registry, world, window, center):
    """From-scratch window at `center` (the ground truth of a shift)."""
    gen = WorldGenerator(world, registry)
    cs = world.chunk_size
    wx, wy, wz = window
    grid = np.zeros(((2 * wx + 1) * cs, (2 * wy + 1) * cs,
                     (2 * wz + 1) * cs), np.uint8)
    for dx in range(-wx, wx + 1):
        for dy in range(-wy, wy + 1):
            for dz in range(-wz, wz + 1):
                key = (center[0] + dx, center[1] + dy, center[2] + dz)
                grid[(dx + wx) * cs:(dx + wx + 1) * cs,
                     (dy + wy) * cs:(dy + wy + 1) * cs,
                     (dz + wz) * cs:(dz + wz + 1) * cs] = \
                    gen.generate_chunk(key)
    origin = ((center[0] - wx) * cs, (center[1] - wy) * cs,
              (center[2] - wz) * cs)
    return grid, origin


def test_incremental_window_shift_matches_full_rebuild(registry,
                                                       jax_registry):
    """tests/test_incremental.py's test on the port, without its window
    pack: after each recenter the host and device grid and aux equal a
    from-scratch window's, and equal the JAX scene's after the same
    recenters."""
    world = WorldSettings(chunk_size=8, load_radius=2, evict_radius=3)
    jworld = JaxWorldSettings(chunk_size=8, load_radius=2, evict_radius=3)
    window = (2, 1, 2)
    shape = (5 * 8, 3 * 8, 5 * 8)
    scene = VoxelScene(registry, np.zeros(shape, np.uint8), (-16, -8, -16),
                       max_light_prims=256, device="cpu")
    jscene = JaxVoxelScene(jax_registry, np.zeros(shape, np.uint8),
                           (-16, -8, -16), max_light_prims=256)
    cm = ChunkManager(world, registry, scene, window_chunks=window,
                      synchronous=True)
    jcm = JaxChunkManager(jworld, jax_registry, jscene, window_chunks=window,
                          synchronous=True)

    def step(m, center):
        if center != m.center_chunk:
            m.center_chunk = center
            m._window_dirty = True
        for key in m._window_keys(center):
            m._request_chunk(key)
        m._evict()
        if m._window_dirty:
            m._rebuild_window()

    step(cm, (0, 0, 0))
    step(jcm, (0, 0, 0))
    a0 = scene.get_arrays()
    jscene.get_arrays()
    for center in [(1, 0, 0), (1, 0, -1), (2, 0, -1)]:
        step(cm, center)
        step(jcm, center)
        got = scene.get_arrays()
        assert got is not a0
        want_grid, want_origin = _fresh_window(registry, world, window,
                                               center)
        want_aux = make_aux_grid(want_grid, scene._transparent,
                                 scene._translucent)
        np.testing.assert_array_equal(scene.grid, want_grid)
        np.testing.assert_array_equal(scene._aux, want_aux)
        np.testing.assert_array_equal(got.grid.numpy(), want_grid)
        np.testing.assert_array_equal(got.aux_grid.numpy(), want_aux)
        assert got.grid_origin == want_origin
        np.testing.assert_array_equal(scene.grid, jscene.grid)
        equal_aux(scene._aux, jscene._aux)
        jl = jscene._arrays.lights
        assert got.lights.num_prims == int(jl.num_prims)
        n = got.lights.num_prims
        np.testing.assert_allclose(got.lights.p0[:n].numpy(),
                                   np.asarray(jl.p0)[:n], atol=1e-6)


def close(got, want):
    assert np.all(np.isfinite(got))
    d = np.abs(got - want)
    assert d.max() < 1e-3, d.max()
    assert np.sqrt((d ** 2).mean()) < 1e-5


FRAME = dict(width=48, height=48, num_bounces=2, compaction=True)


def test_edited_frames_match_jax_renderer(registry, jax_registry):
    """The golden scene after a glass edit, then after a lamp edit (which
    rebuilds the light set), rendered on live arrays by the port and by
    the JAX Renderer after the same edits."""
    grid = config1_grid(registry)
    scene = VoxelScene(registry, grid, (0, 0, 0), max_light_prims=256,
                       device="cpu")
    jscene = JaxVoxelScene(jax_registry, grid, (0, 0, 0),
                           max_light_prims=256)
    basis = config1_pose()
    port = Renderer(RenderSettings(**FRAME), device="cpu")
    jax_r = JaxRenderer(JaxSettings(shade_fused=True, use_column_trace=False,
                                    max_trace_steps=512, **FRAME))
    # live arrays before the edits, so both take the incremental path
    port.render(scene, basis, RenderingPreferences(nee_type=1))
    jscene.get_arrays()
    edits = [((10, 5, 8), "glass"), ((11, 6, 8), "glass"),
             ((4, 5, 10), "lamp")]
    for pos, name in edits:
        for s in (scene, jscene):
            s.set_block(pos, registry.block_idx(name))
        got = port.render(scene, basis, RenderingPreferences(nee_type=1),
                          frame_count=3)
        want = np.asarray(jax_r.render(jscene, basis, JaxPrefs(nee_type=1),
                                       frame_count=3))
        assert got.mean() > 1e-3
        close(got, want)


def test_cached_primary_frame_after_an_edit(registry):
    """A cache_primary renderer keeps its bounce-0 hits only while the scene
    arrays are the same object: after an edit in view its frame equals an
    uncached renderer's bit for bit, and the shade tables are kept over an
    edit that leaves the lights alone."""
    grid = config1_grid(registry)
    scene = VoxelScene(registry, grid, (0, 0, 0), max_light_prims=256,
                       device="cpu")
    basis = config1_pose()
    prefs = RenderingPreferences(nee_type=1)
    cached = Renderer(RenderSettings(cache_primary=True, **FRAME),
                      device="cpu")
    cached.render(scene, basis, prefs, frame_count=1)
    before = cached.render(scene, basis, prefs, frame_count=2)
    tables = cached._tables[2]
    assert cached._primary is not None
    # a stone pillar in front of the camera's view of the lamp
    for y in range(5, 9):
        scene.set_block((9, y, 9), registry.block_idx("stone"))
    got = cached.render(scene, basis, prefs, frame_count=2)
    assert cached._tables[2] is tables
    want = Renderer(RenderSettings(**FRAME), device="cpu").render(
        scene, basis, prefs, frame_count=2)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(want, before)
    # and the cache is held again for the new arrays
    assert cached._primary[0] is scene.get_arrays()
    np.testing.assert_array_equal(
        cached.render(scene, basis, prefs, frame_count=2), want)

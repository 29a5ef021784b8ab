"""The lamp-lit streamed window (`headline.py::window_lamps`,
`lamps_setup`) and the benchmark reference's light walk
(`benchmark/reference/lamps.py`), on the CPU.

The reference's stochastic walk picks the prim `wavefront.
traverse_light_bvh` picks, ray for ray, on seeded random sparse light
sets, with the same probability; `window_lamps` agrees with the
reference's own copy of the lamp rule and gives a sparse light set with
every lamp on the ground; the general shade names its light pick, NEE
pdf sweep and texel fetch in spans, and counts the sweep's crossings and
the walk's levels without a host sync of its own; and a small frame of `lamps_setup` (a
radius-5 window, 32x18, 2 bounces, the general shade path) matches the
reference pixel for pixel, where the bfloat16 color pipeline does not.
"""

from collections import Counter

import numpy as np
import pytest
import torch
from _torch_threads import one_thread  # noqa: F401
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import check
from benchmark.reference import lamps as ref_lamps
from benchmark.reference import lights as ref_lights
from benchmark.reference import world
from benchmark.reference.render import combine, rand
from wavefront_tpu_torch.core.config import EPSILON_BLOCK
from wavefront_tpu_torch.core.vec3 import V3
from wavefront_tpu_torch.headline import lamps_setup, window_lamps
from wavefront_tpu_torch.render import lights as lights_mod
from wavefront_tpu_torch.render.renderer import Renderer
from wavefront_tpu_torch.render.scene import light_arrays
from wavefront_tpu_torch.render.wavefront import traverse_light_bvh
from wavefront_tpu_torch.utils.profiling import counters
from wavefront_tpu_torch.world.blocks import BlockRegistry

ASSETS = "assets"
RADIUS = 5
# the benchmark's limit on the cell's off_share (limits/lamps.orbit.json)
LIMIT = 0.1


def random_lamps(seed: int, count: int = 48, size=(48, 24, 48)):
    """A grid of air with `count` lamps at seeded cells, apart from each
    other, so that each shows six faces: a light set of 288 prims."""
    reg = BlockRegistry.load(ASSETS)
    rng = np.random.default_rng(seed)
    grid = np.full(size, reg.air, np.uint8)
    placed = 0
    while placed < count:
        c = tuple(int(rng.integers(1, s - 1)) for s in size)
        if (grid[c[0] - 1:c[0] + 2, c[1] - 1:c[1] + 2, c[2] - 1:c[2] + 2]
                == reg.air).all():
            grid[c] = reg.block_idx("lamp")
            placed += 1
    return reg, grid, (-24, 0, -24)


def ref_margin(ref, point, normal, seed):
    """The walk's smallest gap between its uniform and the left share,
    over the levels each ray steps (the reference's own float64 walk)."""
    imp = ref._importance(point, normal, ref_lamps.EPS)
    n = point.shape[0]
    node = torch.zeros(n, dtype=torch.int64)
    margin = torch.full((n,), np.inf, dtype=torch.float64)
    s = seed
    while True:
        step = ref.n_left[node] >= 0
        if not bool(step.any()):
            return margin
        li = ref.n_left[node].clamp(min=0)
        ri = torch.where(step, ref.n_right[node], li)
        il, ir = imp[torch.arange(n), li], imp[torch.arange(n), ri]
        tot = il + ir
        share = torch.where(tot > 0, il / torch.where(tot > 0, tot, 1.0),
                            0.0)
        u = rand(s)
        margin = torch.where(step, torch.minimum(margin, (u - share).abs()),
                             margin)
        node = torch.where(step, torch.where(u < share, li, ri), node)
        s = combine(s, 0)


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_reference_walk_picks_the_program_walks_prim(seed):
    reg, grid, origin = random_lamps(seed)
    ls = lights_mod.build_from_grid(grid, np.asarray(origin), reg, 1024)
    la = light_arrays(ls, "cpu")
    assert not la.dense and la.num_prims > 256
    blocks = world.load_blocks(ASSETS)
    assert blocks.index("lamp") == reg.block_idx("lamp")
    assert blocks.air == reg.air
    rl = ref_lights.light_set(grid, origin, blocks)
    ref = ref_lamps.LampReference(grid, origin, blocks, rl)
    assert rl.count == la.num_prims

    rng = np.random.default_rng(seed + 100)
    n = 1000
    lo = np.asarray(origin, np.float64)
    pts = (lo + rng.random((n, 3)) * np.asarray(grid.shape)).astype(
        np.float32)
    axis, sign = rng.integers(0, 3, n), rng.choice([-1.0, 1.0], n)
    nrm = np.zeros((n, 3), np.float32)
    nrm[np.arange(n), axis] = sign
    seeds = rng.integers(0, 2**32, n, dtype=np.int64)

    def v3(a):
        return V3(*(torch.as_tensor(a[:, c]) for c in range(3)))

    got = traverse_light_bvh(la, v3(pts), v3(nrm), torch.as_tensor(seeds),
                             torch.ones(n, dtype=torch.bool), 32)
    p64 = torch.as_tensor(pts, dtype=torch.float64)
    n64 = torch.as_tensor(nrm, dtype=torch.float64)
    s64 = torch.as_tensor(seeds)
    prim, good = ref.light_pick(p64, n64, s64)
    assert got.success.all()
    # prims in the two builders' order: the same SAH gives the same order
    np.testing.assert_array_equal(rl.p0, ls.p0[:rl.count])
    clear = ref_margin(ref, p64, n64, s64) > 1e-5
    assert clear.float().mean() > 0.99
    same = got.prim.numpy() == prim.numpy()
    assert same[clear.numpy()].all()
    np.testing.assert_array_equal(
        (got.importance > 0).numpy()[clear.numpy()],
        good.numpy()[clear.numpy()])
    # the pick's probability is the product the NEE pdf sums
    probs, _ = ref._prim_probs(p64, n64, ref_lamps.EPS)
    want = probs.gather(1, prim[:, None]).squeeze(1).numpy()
    ok = clear.numpy() & (want > 0)
    np.testing.assert_allclose(got.probability.numpy()[ok], want[ok],
                               rtol=1e-5)
    assert ref_lamps.EPS == pytest.approx(EPSILON_BLOCK)


@pytest.fixture(scope="module")
def window():
    """The program's lamp-lit radius-5 window and the reference's."""
    torch.set_num_threads(1)
    scene, cm, settings, basis, prefs = lamps_setup(32, 18, 2, device="cpu",
                                                    load_radius=RADIUS)
    blocks = world.load_blocks(ASSETS)
    size = scene.grid.shape
    terrain = world.terrain(blocks, scene.grid_origin, size, "cpu").numpy()
    grid = terrain.copy()
    for c in ref_lamps.lamp_cells(terrain, blocks.air):
        grid[c] = blocks.index("lamp")
    ref = ref_lamps.LampReference(
        grid, scene.grid_origin, blocks,
        ref_lights.light_set(grid, scene.grid_origin, blocks))
    return scene, cm, settings, basis, prefs, blocks, terrain, ref


def test_window_lamps_rest_on_the_ground_and_match_the_reference(window):
    scene, cm, _, _, _, blocks, terrain, _ = window
    reg = cm.registry
    lamp = reg.block_idx("lamp")
    cells = window_lamps(terrain, reg)
    assert cells == ref_lamps.lamp_cells(terrain, blocks.air)
    assert len(cells) > 60
    grid = scene.grid
    # the worldgen's own lamps aside
    placed = np.argwhere((grid == lamp) & (terrain != lamp))
    assert sorted(map(tuple, placed.tolist())) == sorted(cells)
    for x, y, z in cells:
        assert terrain[x, y, z] == reg.air
        assert terrain[x, y - 1, z] != reg.air
        assert (terrain[x, y:, z] == reg.air).all()
        assert y < grid.shape[1] - 1
    la = scene.get_arrays().lights
    assert not la.dense and la.num_prims > 256
    # the manager's chunks hold the lamps as well
    x, y, z = np.add(scene.grid_origin, cells[0])
    key, b = (x // 32, y // 32, z // 32), (x % 32, y % 32, z % 32)
    assert cm.chunks[key][b] == lamp


def _off_share(window, shade_bf16: bool, frames: int = 4):
    """off_share (harness/check.py) of every pixel of `frames` frames."""
    scene, _, settings, basis, prefs, _, _, ref = window
    renderer = Renderer(settings.replace(shade_bf16=shade_bf16),
                        device="cpu")
    w, h = settings.width, settings.height
    pix = np.arange(w * h)
    o, d = ref.rays(pix, w, h, world.orbit_basis([0.0, 14.0, 0.0], 26.0,
                                                 0.35, -0.55))
    off = lit = 0
    for fc in range(3_000_000_019, 3_000_000_019 + frames):
        with pytest.warns(UserWarning, match="general shade path"):
            img, aux = renderer.render(scene, basis, prefs, frame_count=fc,
                                       with_aux=True)
        assert aux == {"truncated": 0, "nee_overflow": 0}
        want = ref.paths(o, d, pix, np.full(len(pix), fc),
                         settings.num_bounces, prefs.nee_type).numpy()
        o_, l_ = check.off_lit(np.asarray(img).reshape(-1, 3), want)
        off, lit = off + o_, lit + l_
    assert lit > 25 * frames
    return off / lit


def test_small_frame_matches_the_reference_and_bf16_does_not(window):
    share = _off_share(window, False)
    assert share < LIMIT / 5
    assert _off_share(window, True, frames=2) > LIMIT > share


def test_shade_spans_and_counters(window):
    """Each bounce of the general shade opens `render.light_pick`,
    `render.nee_pdf` and `render.texel` inside `render.shade`; the walk's
    levels are its level tests less the one that ends each walk; the
    counters read the same with no profiler session, and every host sync
    is one `sync.*` span."""
    scene, _, settings, basis, prefs, *_ = window
    renderer = Renderer(settings.replace(width=16, height=9), device="cpu")

    def frame():
        before = counters()
        with pytest.warns(UserWarning, match="general shade path"):
            renderer.render(scene, basis, prefs, frame_count=77,
                            with_aux=True)
        after = counters()
        return {k: after[k] - before[k] for k in after}

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        d = frame()
    # the session's raw events: `prof.events()` takes seconds to build
    names = Counter(e.name() for e in prof.profiler.kineto_results.events())
    b = settings.num_bounces
    assert names["render.shade"] == b
    for n in ("render.light_pick", "render.nee_pdf", "render.texel"):
        assert names[n] == b, n
    assert d["light_walk_levels"] == names["sync.light_walk"] - b > b
    assert d["nee_crossings"] > 0
    assert d["host_syncs"] == sum(v for n, v in names.items()
                                  if n.startswith("sync."))
    assert frame() == d

"""The forward light walk's kernel (`kernels/light_walk.py`,
`csrc/light_walk.cu`, S4) against its plain version
(`render/wavefront.py::light_walk_plain`).

On the CPU: `traverse_light_bvh` takes the plain walk for CPU tensors and
never the kernel, with a host sync a level; the kernel's wrapper refuses
CPU tensors; the levels `tools/kernel_times.py` bounds the kernel by
(`walk_levels`, from the walk's result) equal the levels counted by
walking again with every smaller level cap; each library that includes
`csrc/light_bvh.cuh` is named by a hash of it.  The plain walk itself is
held to the JAX package in tests/test_torch_lights.py and to the
benchmark's reference in tests/test_torch_lamps.py.

On the card (marker `cuda`; this file imports no JAX, so it runs there
with `--noconftest`): the kernel against the plain walk on the same CUDA
tensors, on seeded sparse light sets built as the port builds them (a
lamp room, the lamps in open air of tests/test_torch_lamps.py, seeded
quads and triangles, the lamp-lit window's set), on a one-prim set (the
root is a leaf), an empty set (the dummy root), a set whose node table
has 4,096 rows (four times the lamp-lit window's), at level caps below
the tree's depth,
and on 524,288 rays, more than the card keeps resident, so that the
persistent grid's blocks stride past their first group of rays.  Every
case holds inactive rays, rays whose points lie above every light with
their normals up (both children's importance 0 at every split: the walk
goes right with importance 0) and inactive rays at non-finite points.
The kernel repeats the plain walk's float32 operations and murmur3 draws,
so success and prim are equal on every ray and probability and
importance bit for bit (NaN where the plain walk's is NaN).  One launch a
call, none for no rays; a frame's walks take no host sync.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from wavefront_tpu_torch.core.vec3 import V3
from wavefront_tpu_torch.headline import general_setup, lamps_setup
from wavefront_tpu_torch.kernels import _build
from wavefront_tpu_torch.kernels.light_walk import light_walk
from wavefront_tpu_torch.render import lights as lights_mod
from wavefront_tpu_torch.render import renderer as rr
from wavefront_tpu_torch.render import wavefront as wf
from wavefront_tpu_torch.render.scene import light_arrays
from wavefront_tpu_torch.tools import kernel_times
from wavefront_tpu_torch.utils import spans
from wavefront_tpu_torch.world.blocks import BlockRegistry

from _card import same_bits
from _light_sets import lamp_room, quads_and_tris

N = 1 << 15
# rays of the case past the kernel's resident grid: more than the 2048
# threads an SM holds at once, on every SM of a 132-SM card
N_GRID = 1 << 19
DEPTH = 32


@pytest.fixture(scope="module")
def registry():
    return BlockRegistry.load("assets")


def open_lamps(registry, seed: int, count: int = 48, size=(48, 24, 48)):
    """`count` lamps at seeded cells of a grid of air, apart from each
    other (tests/test_torch_lamps.py's `random_lamps`): 288 prims."""
    g = np.random.default_rng(seed)
    grid = np.full(size, registry.air, np.uint8)
    placed = 0
    while placed < count:
        c = tuple(int(g.integers(1, s - 1)) for s in size)
        if (grid[c[0] - 1:c[0] + 2, c[1] - 1:c[1] + 2, c[2] - 1:c[2] + 2]
                == registry.air).all():
            grid[c] = registry.block_idx("lamp")
            placed += 1
    return lights_mod.build_from_grid(grid, np.asarray((-24, 0, -24)),
                                      registry, 1024)


def light_set(name: str, registry):
    if name == "room":
        return lamp_room(registry, 24, 20, 7)
    if name.startswith("open_"):
        return open_lamps(registry, int(name[5:]))
    if name == "quads_tris":
        return quads_and_tris(300, 5)
    if name == "one_prim":
        return quads_and_tris(1, 9)
    if name == "empty":
        z = np.zeros((0, 3), np.float32)
        return lights_mod.build_light_set(z, z, z, np.zeros(0, np.float32),
                                          np.zeros(0, bool), 64,
                                          dense_threshold=8)
    # "large": 2,199 nodes, the node bucket of 4,096 rows
    return quads_and_tris(1100, 17)


def rays(p0, n: int, seed: int):
    """(point, normal, seed, active) as numpy: seeded points around the
    light prims' corners `p0` with seeded unit normals (a third of them
    along an axis); one in ten above every light with its normal up,
    where both children of every node have importance 0; seeds over all
    32 bits; 85% active, and one inactive ray in twenty at a non-finite
    point."""
    g = np.random.default_rng(seed)
    if len(p0):
        lo, hi = p0.min(0) - 4, p0.max(0) + 4
    else:
        lo, hi = np.zeros(3), np.full(3, 8.0)
    point = g.uniform(lo, hi, (n, 3))
    normal = g.normal(0, 1, (n, 3))
    axis = g.random(n) < 0.3
    normal[axis] = np.eye(3)[g.integers(0, 3, axis.sum())] \
        * g.choice([-1.0, 1.0], (axis.sum(), 1))
    normal /= np.linalg.norm(normal, axis=1, keepdims=True)
    above = g.random(n) < 0.1
    point[above, 1] = hi[1] + g.uniform(1, 4, above.sum())
    normal[above] = [0.0, 1.0, 0.0]
    active = g.random(n) < 0.85
    odd = ~active & (g.random(n) < 0.3)
    point[odd] = g.choice([np.nan, np.inf, -np.inf], (odd.sum(), 3))
    seeds = g.integers(0, 2 ** 32, n, dtype=np.int64)
    return (point.astype(np.float32), normal.astype(np.float32), seeds,
            active)


def _v3(a, dev):
    return V3(*(torch.as_tensor(np.ascontiguousarray(a[:, i]), device=dev)
                for i in range(3)))


def tensors(ls, n: int, seed: int, dev, la=None):
    """(LightArrays, point, normal, seed, active) on `dev`: the seeded
    rays (`rays`) about light set `ls` (or about `la`, given)."""
    la = light_arrays(ls, dev) if la is None else la
    point, normal, seeds, active = rays(
        la.p0[:la.num_prims].cpu().numpy(), n, seed)
    return (la, _v3(point, dev), _v3(normal, dev),
            torch.as_tensor(seeds, device=dev),
            torch.as_tensor(active, device=dev))


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_walk(registry):
    """`traverse_light_bvh` on CPU tensors is the plain walk, a host sync
    a level and no launch; the kernel's wrapper refuses CPU tensors."""
    la, p, nrm, seed, active = tensors(light_set("room", registry), 2048, 1,
                                       "cpu")
    before, syncs = light_walk.launches, spans.host_syncs
    levels = spans.light_walk_levels
    want = wf.light_walk_plain(la, p, nrm, seed, active, DEPTH)
    plain_syncs = spans.host_syncs - syncs
    got = wf.traverse_light_bvh(la, p, nrm, seed, active, DEPTH)
    assert light_walk.launches == before
    assert spans.host_syncs - syncs == 2 * plain_syncs > 2
    assert spans.light_walk_levels - levels == 2 * (plain_syncs - 1)
    for g, w in zip(got, want):
        assert same_bits(g, w)
    assert int(got.success.sum()) > 1000
    with pytest.raises(ValueError, match="CUDA tensors only"):
        light_walk(la, p, nrm, seed, active, DEPTH)


@pytest.mark.parametrize("depth", [3, DEPTH])
def test_kernel_times_counts_the_levels_stepped(registry, depth):
    """`tools/kernel_times.py::walk_levels`, which S4's operations bound is
    counted from, equals the levels stepped by rays counted apart from it:
    a ray steps level k when the walk capped at k levels has not reached
    its leaf (the capped walks are prefixes of the whole one)."""
    la, p, nrm, seed, active = tensors(light_set("room", registry), 2048, 2,
                                       "cpu")
    got = wf.light_walk_plain(la, p, nrm, seed, active, depth)
    want = sum(int((active & ~wf.light_walk_plain(
        la, p, nrm, seed, active, k).success).sum()) for k in range(depth))
    assert kernel_times.walk_levels(la, got.success, got.prim, active,
                                    depth) == want > 2048


def test_each_includer_of_the_light_bvh_header_hashes_it(tmp_path,
                                                         monkeypatch):
    """A library's name hashes the `csrc/` headers its source includes:
    an edit of `light_bvh.cuh` renames S3's, S4's and K2's libraries, so
    none is loaded stale; a source that includes none keeps its name."""
    includers = [n for n in _build.SOURCES if '#include "light_bvh.cuh"'
                 in open(os.path.join(_build.CSRC, n + ".cu")).read()]
    assert sorted(includers) == ["light_walk", "nee_sweep", "shade"]
    for name in os.listdir(_build.CSRC):
        shutil.copy(os.path.join(_build.CSRC, name), tmp_path)
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    before = {n: _build._lib_path(n) for n in _build.SOURCES}
    with open(tmp_path / "light_bvh.cuh", "a") as f:
        f.write("\n// edited\n")
    after = {n: _build._lib_path(n) for n in _build.SOURCES}
    assert {n for n in before if before[n] != after[n]} == set(includers)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def hold(la, p, nrm, seed, active, depth: int):
    """The kernel against the plain walk on these rays: one launch; every
    output equal (`same_bits`).  Returns the kernel's sample."""
    before = light_walk.launches
    got = wf.traverse_light_bvh(la, p, nrm, seed, active, depth)
    assert light_walk.launches == before + 1
    want = wf.light_walk_plain(la, p, nrm, seed, active, depth)
    for field, g, w in zip(wf.BvhSample._fields, got, want):
        assert same_bits(g, w), field
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [2, 5, DEPTH])
@pytest.mark.parametrize("name", ["room", "open_11", "open_12", "open_13",
                                  "quads_tris", "large"])
def test_kernel_matches_plain(card, registry, name, depth):
    ls = light_set(name, registry)
    la, p, nrm, seed, active = tensors(ls, N, 20 + depth, card)
    rows = la.node_min.shape[0]
    assert rows == 4096 if name == "large" else rows <= 1024
    got = hold(la, p, nrm, seed, active, depth)
    ok = got.success
    assert not bool(ok[~active].any())
    if depth == DEPTH:
        # the importance-0 rays went right at every split and still reached
        # a leaf; most others picked a lit prim
        assert int(ok.sum()) > N // 2
        assert int((ok & (got.importance > 0)).sum()) > N // 3
        assert len(torch.unique(got.prim[ok])) > ls.num_prims // 4
    else:
        # the cap stops walks short of their leaves
        assert int((active & ~ok).sum()) > N // 10


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["one_prim", "empty"])
def test_kernel_matches_plain_on_a_root_leaf(card, registry, name):
    """A one-prim set: the root is the leaf, every active ray picks prim 0
    with probability 1 and the root's importance, no level stepped; an
    empty set: the dummy root, no ray succeeds."""
    ls = light_set(name, registry)
    la, p, nrm, seed, active = tensors(ls, N, 30, card)
    got = hold(la, p, nrm, seed, active, DEPTH)
    if name == "one_prim":
        assert torch.equal(got.success, active)
        assert bool((got.probability == 1).all())
    else:
        assert not bool(got.success.any())


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_lamp_lit_windows_set(card):
    """The `lamps.orbit` cell's light set (476 prims, 1,024 node rows), on
    seeded rays about it."""
    scene = lamps_setup(64, 36, 1, device="cuda")[0]
    la = scene.get_arrays().lights
    assert not la.dense and la.num_prims == 476
    assert la.node_min.shape[0] == 1024
    got = hold(*tensors(None, N_GRID // 4, 31, card, la), DEPTH)
    assert int(got.success.sum()) > N_GRID // 8


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["room", "large"])
def test_kernel_matches_plain_past_its_resident_grid(card, registry, name):
    """N_GRID rays, more than the card holds resident at once: the
    persistent grid's blocks stride past their first group of rays."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert N_GRID > sms * 2048
    la, p, nrm, seed, active = tensors(light_set(name, registry), N_GRID,
                                       40, card)
    hold(la, p, nrm, seed, active, DEPTH)


@pytest.mark.cuda
def test_kernel_one_launch_a_call_and_none_for_no_rays(card, registry):
    la, p, nrm, seed, active = tensors(light_set("room", registry), 1000, 4,
                                       card)
    before = light_walk.launches
    a = light_walk(la, p, nrm, seed, active, DEPTH)
    b = light_walk(la, p, nrm, seed, active, DEPTH)
    assert light_walk.launches == before + 2
    assert all(same_bits(x, y) for x, y in zip(a, b))
    empty = V3(*(c[:0] for c in p))
    got = light_walk(la, empty, empty, seed[:0], active[:0], DEPTH)
    assert [t.shape for t in got] == [(0,)] * 4
    assert light_walk.launches == before + 2
    with pytest.raises(ValueError):
        light_walk(la, p, nrm, seed.int(), active, DEPTH)
    with pytest.raises(ValueError):
        light_walk(la, p, nrm, seed, active.to(torch.uint8), DEPTH)
    with pytest.raises(ValueError):
        light_walk(la, p, nrm, seed, active, -1)


@pytest.mark.cuda
def test_frame_walks_take_no_host_sync(card):
    """A general frame on a sparse light set: one kernel launch a bounce
    and no host sync inside any walk; no level counted."""
    scene, settings, basis, prefs = general_setup(128, 72, 4, device="cuda")
    calls, real = [], rr.traverse_light_bvh

    def spy(*a, **kw):
        syncs, launches = spans.host_syncs, light_walk.launches
        out = real(*a, **kw)
        calls.append((spans.host_syncs - syncs,
                      light_walk.launches - launches))
        return out

    renderer = rr.Renderer(settings)
    renderer.render(scene, basis, prefs, 1)
    rr.traverse_light_bvh = spy
    try:
        levels = spans.light_walk_levels
        _, aux = renderer.render(scene, basis, prefs, 2, with_aux=True)
    finally:
        rr.traverse_light_bvh = real
    assert calls == [(0, 1)] * settings.num_bounces
    assert spans.light_walk_levels == levels
    assert aux == {"truncated": 0, "nee_overflow": 0}

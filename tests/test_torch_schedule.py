"""The bounce-sort and tracer settings the port honours as the JAX package
does: `sort_bounces`, `trace_skips` and `trace_presort`.

Frames are held port against port, where the JAX package already holds
the same property of its own frames (tests/test_golden.py holds its sort
schedules to its every-bounce sort; tests/test_torch_render.py holds the
two packages' every-bounce frames): a one-chunk worldgen scene at 32x32,
4 bounces, compaction and NEE 1, within 1e-5 of the every-bounce frame.
The compaction bucket and the sort keys are held to the JAX package's
own formulas and functions exactly, on seeded inputs.  One sorted
`debug_view` frame (it paints ray slots, so it depends on the sort key)
is held to the JAX frame with `trace_presort=False`.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from wavefront_tpu.core import morton as jax_morton
from wavefront_tpu.core.config import RenderingPreferences as JaxPrefs
from wavefront_tpu.core.config import RenderSettings as JaxSettings
from wavefront_tpu.render.renderer import Renderer as JaxRenderer
from wavefront_tpu.render.scene import VoxelScene as JaxVoxelScene
from wavefront_tpu.world.blocks import BlockRegistry as JaxBlockRegistry
from wavefront_tpu_torch.core import morton
from wavefront_tpu_torch.core.camera import SphericalCamera
from wavefront_tpu_torch.core.config import (
    RenderingPreferences,
    RenderSettings,
    WorldSettings,
)
from wavefront_tpu_torch.core.vec3 import V3
from wavefront_tpu_torch.headline import build_scene, config1_grid, config1_pose
from wavefront_tpu_torch.kernels.window_trace import coherence_key
from wavefront_tpu_torch.render import renderer as rr
from wavefront_tpu_torch.render.scene import VoxelScene
from wavefront_tpu_torch.world.blocks import BlockRegistry

ASSETS = "assets"
FRAME = RenderSettings(width=32, height=32, num_bounces=4, compaction=True)
PREFS = RenderingPreferences(nee_type=1)


@pytest.fixture(scope="module")
def chunk():
    """A one-chunk worldgen scene and a pose looking across it: rays
    miss, hit terrain and die across the bounces (a third of them alive
    after bounce 0)."""
    reg = BlockRegistry.load(ASSETS)
    grid, origin = build_scene(reg, WorldSettings(), span=0)
    scene = VoxelScene(reg, grid, origin, max_light_prims=1024, device="cpu")
    cam = SphericalCamera()
    cam.set_root_position([16.0, 12.0, 16.0])
    cam.offset = 10.0
    cam.yaw = 0.6
    cam.pitch = -0.3
    return scene, cam.eye_front_right_up()


def render(chunk, settings=FRAME, prefs=PREFS, frame=2):
    scene, basis = chunk
    return rr.Renderer(settings, device="cpu").render(scene, basis, prefs,
                                                      frame_count=frame)


@pytest.fixture(scope="module")
def every_bounce(chunk):
    img = render(chunk)
    assert img.mean() > 1e-3
    return img


def jax_bucket(alive: np.ndarray, sorted_now: bool) -> int:
    """The JAX renderer's bucket (wavefront_tpu/render/renderer.py:861-875
    and its `make_branch`), on a numpy mask."""
    a = jnp.asarray(alive)
    n = a.shape[0]
    if sorted_now:
        count = a.sum()
    else:
        count = jnp.where(a.any(), n - jnp.argmax(a[::-1]), 0)
    idx = int((count <= n // 2).astype(jnp.int32)
              + (count <= n // 4).astype(jnp.int32))
    return max(n >> idx, 1)


@pytest.mark.parametrize("sched", [(1,), (1, 2), (), None],
                         ids=["b1", "b1-b2", "none", "all"])
def test_schedule_matches_every_bounce_sort(chunk, every_bounce, sched,
                                            monkeypatch):
    """Each schedule gives the every-bounce image within 1e-5, sorts on
    the scheduled bounces only, and sizes each compaction bucket as the
    JAX package does: from the alive count after a sort, from the last
    alive slot after a skipped one."""
    sorts, buckets = [], []
    real_sort, real_bucket = rr.coherence_sort, rr.compaction_bucket

    def count_sort(*a, **kw):
        sorts.append(1)
        return real_sort(*a, **kw)

    def spy_bucket(alive, sorted_now):
        m, count = real_bucket(alive, sorted_now)
        buckets.append((alive.numpy().copy(), sorted_now, m))
        return m, count

    monkeypatch.setattr(rr, "coherence_sort", count_sort)
    monkeypatch.setattr(rr, "compaction_bucket", spy_bucket)
    img = render(chunk, FRAME.replace(sort_bounces=sched))
    np.testing.assert_allclose(img, every_bounce, rtol=0, atol=1e-5)
    want = [b for b in range(4) if sched is None or b in sched]
    assert len(sorts) == len(want)
    assert [s for _, s, _ in buckets] == [b in want for b in range(4)]
    for alive, sorted_now, m in buckets:
        assert m == jax_bucket(alive, sorted_now)
    if sched == (1,):
        # bounce 2 traces in bounce 1's order, with holes the bucket
        # must cover: smaller than the frame, larger than the count needs
        alive, _, m = buckets[2]
        assert rr.compaction_bucket(torch.as_tensor(alive), True)[0] < m \
            < alive.size


def test_ranges_and_batches_take_the_schedule(chunk, monkeypatch):
    """Pixel ranges (`DistributedRenderer`) and batches
    (`render_batch`) reach the schedule through `render_frame`: each
    range and each frame sorts on the scheduled bounce only, and both
    give the single frame's image bit for bit."""
    from wavefront_tpu_torch.parallel.mesh import DistributedRenderer, make_mesh

    scene, basis = chunk
    settings = FRAME.replace(sort_bounces=(1,))
    want = render(chunk, settings)
    sorts = []
    real_sort = rr.coherence_sort

    def count_sort(*a, **kw):
        sorts.append(1)
        return real_sort(*a, **kw)

    monkeypatch.setattr(rr, "coherence_sort", count_sort)
    ranges = DistributedRenderer(settings, make_mesh(devices=["cpu"] * 3))
    np.testing.assert_array_equal(
        ranges.render(scene, basis, PREFS, frame_count=2), want)
    assert len(sorts) == 3
    batch = rr.Renderer(settings, device="cpu").render_batch(
        scene, basis, PREFS, 1, k=2)
    np.testing.assert_array_equal(batch[1], want)
    assert len(sorts) == 5


def masks():
    rng = np.random.default_rng(7)
    out = [np.zeros(64, bool), np.ones(64, bool)]
    for n, p in ((64, 0.1), (64, 0.3), (1024, 0.2), (1024, 0.6), (1, 1.0)):
        out.append(rng.random(n) < p)
    # alive rays leading, as right after a sort, then holes opening
    lead = np.zeros(1024, bool)
    lead[:200] = True
    lead[rng.integers(0, 200, 40)] = False
    out.append(lead)
    return out


@pytest.mark.parametrize("sorted_now", [True, False])
@pytest.mark.parametrize("k", range(len(masks())))
def test_bucket_matches_the_jax_formula(k, sorted_now):
    alive = masks()[k]
    got, count = rr.compaction_bucket(torch.as_tensor(alive), sorted_now)
    assert got == jax_bucket(alive, sorted_now)
    # the alive count where the sort made it the bucket's measure
    assert count == (int(alive.sum()) if sorted_now else None)


def test_trace_skips_off_clears_the_aux_distances(chunk, every_bounce):
    """trace_skips=False hands the tracer an aux grid with no empty-space
    distance (max <= 3) and gives the default image; the default hands it
    the scene's own aux grid, which has distances."""
    scene, basis = chunk
    seen = []

    def spy(arrays, o, d, events):
        seen.append(int(arrays.aux_grid.max()))
        return rr.window_trace(arrays, o, d, events)

    def frame(settings):
        img, _ = rr.render_frame(
            scene.get_arrays(), basis.eye, basis.front, basis.right,
            basis.up, 2, settings=settings, nee_type=1, sort_type=0,
            trace=spy)
        return img.numpy()

    img = frame(FRAME.replace(trace_skips=False))
    np.testing.assert_allclose(img, every_bounce, rtol=0, atol=1e-5)
    assert len(seen) == 4 and max(seen) <= 3
    seen.clear()
    frame(FRAME)
    assert min(seen) > 3


def positions(n=4096, seed=3):
    """Seeded world positions inside and outside [-50, 50], with the
    domain's edges."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(-80.0, 80.0, (n, 3)).astype(np.float32)
    p[:8] = np.array([[-50.0, 50.0, 0.0], [49.99, -49.99, 50.01],
                      [-50.01, 0.05, -0.05], [1e6, -1e6, 0.0],
                      [0.0, 0.0, 0.0], [12.5, -37.5, 25.0],
                      [50.0, 50.0, 50.0], [-50.0, -50.0, -50.0]], np.float32)
    return p


def test_morton_key_matches_jax():
    p = positions()
    want = np.asarray(jax_morton.morton_key_3d_soa(p[:, 0], p[:, 1],
                                                   p[:, 2]))
    t = torch.as_tensor(p)
    got = morton.morton_key_3d_soa(t[:, 0], t[:, 1], t[:, 2])
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    spread = jax_morton.spread_bits_3(np.arange(1024, dtype=np.uint32))
    np.testing.assert_array_equal(
        morton.spread_bits_3(torch.arange(1024)).numpy(),
        np.asarray(spread).astype(np.int64))


@pytest.mark.parametrize("sort_type,compaction", [(1, True), (1, False),
                                                  (0, True)])
def test_sort_key_without_presort(chunk, sort_type, compaction):
    """trace_presort=False keys the bounce sort as the JAX package's
    non-hoisted sort: morton_key_3d_soa(o) >> 1 for sort_type 1, else 0,
    with bit 31 on dead rays under compaction."""
    p = positions(512)
    rng = np.random.default_rng(5)
    d = rng.standard_normal((512, 3)).astype(np.float32)
    d[rng.random(512) < 0.3] = 0.0
    dead = ~np.any(d != 0, axis=1)
    want = np.zeros(512, np.uint32)
    if sort_type == 1:
        want = np.asarray(jax_morton.morton_key_3d_soa(
            p[:, 0], p[:, 1], p[:, 2]) >> np.uint32(1))
    if compaction:
        want = want | np.where(dead, np.uint32(0x80000000), np.uint32(0))
    scene = chunk[0].get_arrays()
    settings = FRAME.replace(trace_presort=False, compaction=compaction)
    key = rr.bounce_sort_key(scene, settings, sort_type,
                             V3.from_array(torch.as_tensor(p)),
                             V3.from_array(torch.as_tensor(d)))
    np.testing.assert_array_equal(key.numpy(), want.astype(np.int64))
    # the default keys on the tracer's coherence key shifted right by 5,
    # as int32 (dead rays last, at bit 26)
    o3, d3 = (V3.from_array(torch.as_tensor(a)) for a in (p, d))
    key = rr.bounce_sort_key(scene, FRAME, sort_type, o3, d3)
    go = scene.grid_origin
    want = coherence_key(o3.x - float(go[0]), o3.y - float(go[1]),
                         o3.z - float(go[2]), *d3, *scene.grid.shape)
    assert key.dtype == torch.int32
    assert torch.equal(key.to(torch.int64) << 5, want)
    assert bool(((key >> 26) == torch.as_tensor(dead).int()).all())


def test_presort_off_matches_every_bounce_sort(chunk, every_bounce):
    for st in (0, 1):
        img = render(chunk, FRAME.replace(trace_presort=False),
                     PREFS.replace(sort_type=st))
        np.testing.assert_allclose(img, every_bounce, rtol=0, atol=1e-5)


def test_sorted_debug_view_matches_jax_without_presort():
    """The ray-layout view paints bounce-1 slots, so it shows the sort's
    order: with trace_presort=False and sort_type 1 both packages sort by
    the same morton key and paint the same image (to the ulp of XLA's
    division by 1023 as a product)."""
    reg, jreg = BlockRegistry.load(ASSETS), JaxBlockRegistry.load(ASSETS)
    grid = config1_grid(reg)
    basis = config1_pose()
    kw = dict(width=48, height=40, num_bounces=2, compaction=True,
              trace_presort=False)
    got = rr.Renderer(RenderSettings(**kw), device="cpu").render(
        VoxelScene(reg, grid, (0, 0, 0), max_light_prims=256, device="cpu"),
        basis, RenderingPreferences(nee_type=1, debug_view=1, sort_type=1))
    want = np.asarray(JaxRenderer(JaxSettings(
        shade_fused=True, use_column_trace=False, max_trace_steps=512,
        **kw)).render(
        JaxVoxelScene(jreg, grid, (0, 0, 0), max_light_prims=256), basis,
        JaxPrefs(nee_type=1, debug_view=1, sort_type=1)))
    np.testing.assert_allclose(got, want, rtol=3e-7, atol=0)
    assert got[..., :2].max() > 0

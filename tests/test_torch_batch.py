"""The port's batched frames, primary-hit cache and temporal accumulator.

`Renderer.render_batch` and `cache_primary` of the port are held to:

  * the JAX `Renderer.render_batch` on the same scene, on the fused and the
    general shade path: max |diff| < 1e-3 and RMS < 1e-5, the bounds of
    tests/test_torch_render.py;
  * the invariants of tests/test_batch.py inside the port, on both shade
    paths: k batched frames equal k single frames of a renderer with the
    same settings bit for bit (without the cache, with it, across a second
    batch on the held cache, with sort and compaction on, and with the
    bf16 color pipeline), and the accumulated image is their mean within
    2e-6;
  * a cached frame against the uncached frame of the same seed within
    max 1e-3 / RMS 1e-5 (0 is what comes out: per-ray arithmetic does not
    depend on ray order);
  * the JAX `TemporalAccumulator` on numpy frames: within 1e-6, a float32
    ulp of the running mean.
"""

import numpy as np
import pytest
import torch

from wavefront_tpu.core.config import RenderingPreferences as JaxPrefs
from wavefront_tpu.core.config import RenderSettings as JaxSettings
from wavefront_tpu.render.accumulate import (
    TemporalAccumulator as JaxAccumulator,
)
from wavefront_tpu.render.renderer import Renderer as JaxRenderer
from wavefront_tpu.render.scene import VoxelScene as JaxVoxelScene
from wavefront_tpu.world.blocks import BlockRegistry as JaxBlockRegistry
from wavefront_tpu_torch.core.config import RenderingPreferences, RenderSettings
from wavefront_tpu_torch.headline import config1_grid, config1_pose
from wavefront_tpu_torch.render import renderer as port_renderer
from wavefront_tpu_torch.render.accumulate import TemporalAccumulator
from wavefront_tpu_torch.render.renderer import Renderer
from wavefront_tpu_torch.render.scene import VoxelScene
from wavefront_tpu_torch.world import meshes
from wavefront_tpu_torch.world.blocks import BlockRegistry

ASSETS = "assets"
SIZE = dict(width=48, height=40, num_bounces=3)
PREFS = RenderingPreferences(nee_type=1)
PATHS = pytest.mark.parametrize("fused", [None, False],
                                ids=["fused", "general"])


def close(got, want):
    assert np.all(np.isfinite(got))
    d = np.abs(got - want)
    assert d.max() < 1e-3, d.max()
    assert np.sqrt((d ** 2).mean()) < 1e-5


@pytest.fixture(scope="module")
def scenes():
    """Config 1 with a cuboid entity over the lamp, for both packages."""
    reg, jreg = BlockRegistry.load(ASSETS), JaxBlockRegistry.load(ASSETS)
    grid = config1_grid(reg)
    port = VoxelScene(reg, grid, (0, 0, 0), max_light_prims=256, device="cpu")
    jax_scene = JaxVoxelScene(jreg, grid, (0, 0, 0), max_light_prims=256)
    box = meshes.cuboid((8.0, 9.5, 8.0), (4.0, 3.0, 4.0))
    port.add_object("box", *box)
    jax_scene.add_object("box", *box)
    return port, jax_scene


def _renderer(fused, **kw):
    return Renderer(RenderSettings(shade_fused=fused, **SIZE, **kw),
                    device="cpu")


def _singles(r, scene, frames, prefs=PREFS):
    basis = config1_pose()
    return np.stack([r.render(scene, basis, prefs, frame_count=f)
                     for f in frames])


@pytest.mark.parametrize("fused,accumulate", [(True, False), (False, True)],
                         ids=["fused-stack", "general-mean"])
def test_render_batch_matches_jax(scenes, fused, accumulate):
    port_scene, jax_scene = scenes
    basis = config1_pose()
    kw = dict(width=32, height=24, num_bounces=2, cache_primary=True)
    got = Renderer(RenderSettings(shade_fused=fused or None, **kw),
                   device="cpu").render_batch(
        port_scene, basis, PREFS, frame_count=5, k=3, accumulate=accumulate)
    want = np.asarray(JaxRenderer(JaxSettings(
        shade_fused=fused, use_column_trace=False, max_trace_steps=512,
        **kw)).render_batch(jax_scene, basis, JaxPrefs(nee_type=1),
                            frame_count=5, k=3, accumulate=accumulate))
    assert got.shape == ((24, 32, 3) if accumulate else (3, 24, 32, 3))
    assert got.mean() > 1e-3
    close(got, want)


@PATHS
def test_batch_matches_singles(scenes, fused):
    scene = scenes[0]
    batch = _renderer(fused).render_batch(scene, config1_pose(), PREFS,
                                          frame_count=7, k=3)
    singles = _singles(_renderer(fused), scene, range(7, 10))
    np.testing.assert_array_equal(batch, singles)
    assert not np.array_equal(batch[0], batch[1])


@PATHS
def test_bf16_batch_matches_singles(scenes, fused):
    """shade_bf16 with the primary cache and sort and compaction on: the
    batched frames equal single frames bit for bit, and the bf16 frames
    are not the float32 ones."""
    scene = scenes[0]
    prefs = RenderingPreferences(nee_type=1, sort_type=1)
    kw = dict(shade_bf16=True, cache_primary=True, compaction=True)
    rb = _renderer(fused, **kw)
    batch = rb.render_batch(scene, config1_pose(), prefs, frame_count=4,
                            k=3)
    assert rb._primary is not None
    np.testing.assert_array_equal(
        batch, _singles(_renderer(fused, **kw), scene, range(4, 7), prefs))
    assert not np.array_equal(batch, _singles(
        _renderer(fused, cache_primary=True, compaction=True), scene,
        range(4, 7), prefs))


@PATHS
def test_batch_accumulate_mean(scenes, fused):
    scene = scenes[0]
    r = _renderer(fused)
    mean, aux = r.render_batch(scene, config1_pose(), PREFS, frame_count=0,
                               k=4, accumulate=True, with_aux=True)
    singles = _singles(_renderer(fused), scene, range(4))
    np.testing.assert_allclose(mean, singles.mean(axis=0), atol=2e-6)
    assert aux["primary"] is None and r._primary is None
    as_tensor = r.render_batch(scene, config1_pose(), PREFS, frame_count=0,
                               k=4, accumulate=True, as_numpy=False)
    assert torch.is_tensor(as_tensor)
    np.testing.assert_array_equal(as_tensor.numpy(), mean)


@PATHS
def test_batch_with_primary_cache(scenes, fused):
    """The first frame fills the cache, the others reuse it; a second
    batch at the same pose reuses the cache the renderer holds; another
    pose, mode or scene does not."""
    scene = scenes[0]
    basis = config1_pose()
    r_single = _renderer(fused, cache_primary=True)
    singles = _singles(r_single, scene, range(3))
    rb = _renderer(fused, cache_primary=True)
    np.testing.assert_array_equal(
        rb.render_batch(scene, basis, PREFS, frame_count=0, k=3), singles)
    held = rb._primary
    assert held is not None and held[2] is not None
    np.testing.assert_array_equal(
        rb.render_batch(scene, basis, PREFS, frame_count=3, k=2),
        _singles(r_single, scene, range(3, 5)))
    assert rb._primary is held
    # a cached frame against the uncached frame of its seed
    uncached = _singles(_renderer(fused), scene, range(3))
    close(singles, uncached)
    np.testing.assert_array_equal(singles, uncached)
    # another mode misses the cache and refills it
    rb.render(scene, basis, RenderingPreferences(nee_type=0))
    assert rb._primary is not held and rb._primary[1] != held[1]


@PATHS
def test_batch_sorted_compacted(scenes, fused):
    """Batch parity holds with sort and compaction on, with and without
    the cache (whose bounce 0 then runs unsorted and uncompacted)."""
    scene = scenes[0]
    prefs = RenderingPreferences(nee_type=1, sort_type=1)
    for kw in (dict(compaction=True),
               dict(compaction=True, cache_primary=True)):
        batch = _renderer(fused, **kw).render_batch(
            scene, config1_pose(), prefs, frame_count=2, k=2)
        np.testing.assert_array_equal(
            batch, _singles(_renderer(fused, **kw), scene, (2, 3), prefs))
    np.testing.assert_array_equal(
        batch, _singles(_renderer(fused), scene, (2, 3), PREFS))


@PATHS
def test_cached_frames_skip_the_primary_trace(scenes, fused, monkeypatch):
    """With the cache held, a frame traces one bounce less and the general
    path sweeps the triangles one time less; jitter turns the cache off."""
    calls = {"trace": 0, "sweep": 0}

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call

    monkeypatch.setattr(port_renderer, "triangle_sweep",
                        counted("sweep", port_renderer.triangle_sweep))
    scene, basis = scenes[0], config1_pose()
    arrays = scene.get_arrays()
    settings = RenderSettings(shade_fused=fused, cache_primary=True, **SIZE)
    kw = dict(settings=settings, nee_type=1, sort_type=0, cache_primary=True,
              trace=counted("trace", port_renderer.window_trace))
    cam = (basis.eye, basis.front, basis.right, basis.up)
    img0, aux = port_renderer.render_frame(arrays, *cam, 0, **kw)
    assert calls == {"trace": 3, "sweep": 3}
    primary = aux["primary"]
    assert len(primary) == (4 if fused is None else 2)
    img1, aux1 = port_renderer.render_frame(arrays, *cam, 0, primary, **kw)
    assert calls == {"trace": 5, "sweep": 5}
    assert torch.equal(img0, img1) and aux1["primary"] is primary
    with pytest.raises(ValueError):
        port_renderer.render_frame(arrays, *cam, 0, primary,
                                   **dict(kw, cache_primary=False))
    jittered = Renderer(settings.replace(jitter=0.5), device="cpu")
    jittered.render(scene, basis, PREFS)
    assert jittered._primary is None


def test_temporal_accumulator_matches_jax():
    rng = np.random.default_rng(21)
    frames = rng.random((6, 12, 16, 3), np.float32)
    port, ref = TemporalAccumulator(), JaxAccumulator()
    assert port.image() is None and port.samples == 0
    for i, f in enumerate(frames[:4]):
        got = port.add(torch.as_tensor(f), key="pose-a")
        want = ref.add(f, key="pose-a")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
        assert port.samples == ref.samples == i + 1
    np.testing.assert_allclose(port.image(), frames[:4].mean(axis=0),
                               atol=1e-6)
    # a new key resets the history; so does a new shape
    port.add(frames[4], key="pose-b")
    ref.add(frames[4], key="pose-b")
    assert port.samples == ref.samples == 1
    np.testing.assert_array_equal(port.image(), frames[4])
    port.add(frames[5, :6], key="pose-b")
    assert port.samples == 1 and port.image().shape == (6, 16, 3)
    # no key keeps the history
    port.add(frames[5, :6])
    assert port.samples == 2

"""The port's main paths on the card: every kernel call of full-size
frames against its plain version, the launches each path makes, and
edited, recentred, played, saved and loaded worlds against a fresh build.

A CUDA kernel has no CPU mode, so these tests need an NVIDIA GPU and
`nvcc`; they carry the `cuda` marker, skip where there is no card and
import no JAX.  The card suite is every such test of the port, in the
five files that hold them (the port's other test files import JAX,
which the card's machine need not have):

    python -m pytest tests/test_torch_card_paths.py tests/test_torch_cuda.py tests/test_torch_nee_sweep.py tests/test_torch_light_walk.py tests/test_torch_tri_sweep.py -q -m cuda --noconftest

The tolerances, the same in every card test, are stated in tests/_card.py.
"""

import io
import os
import urllib.request

import numpy as np
import pytest
import torch

from wavefront_tpu_torch.core.config import (
    RenderingPreferences,
    RenderSettings,
)
from wavefront_tpu_torch.core.vec3 import V3
from wavefront_tpu_torch.headline import (
    add_ego_cube,
    config1_grid,
    config1_pose,
    general_setup,
    headline_setup,
    lamps_setup,
    streamed_setup,
)
from wavefront_tpu_torch.kernels import _build
from wavefront_tpu_torch.kernels import radix_hist as rh
from wavefront_tpu_torch.kernels.light_walk import light_walk
from wavefront_tpu_torch.kernels.nee_sweep import nee_sweep
from wavefront_tpu_torch.kernels.shade import shade_pass, shade_plain
from wavefront_tpu_torch.kernels.texel import texel_fetch, texel_plain
from wavefront_tpu_torch.kernels.window_trace import window_trace
from wavefront_tpu_torch.render import renderer as rr
from wavefront_tpu_torch.render import wavefront as wf
from wavefront_tpu_torch.render.intersect import make_aux_grid, trace_plain
from wavefront_tpu_torch.render.renderer import Renderer, render_frame
from wavefront_tpu_torch.render.scene import VoxelScene
from wavefront_tpu_torch.tools import bench_ladder, kernel_times, sort_sweep
from wavefront_tpu_torch.utils.profiling import counters
from wavefront_tpu_torch.world import meshes
from wavefront_tpu_torch.world.blocks import BlockRegistry
from wavefront_tpu_torch.world.game_world import (
    EntityCreationData,
    EntityPhysicsData,
    GameWorld,
    Mesh,
    WorldSetBlock,
    translation,
)
from wavefront_tpu_torch.world.input import Event

from _card import NEE_REL, bf16_ulp, golden_gate, same_bits

pytestmark = pytest.mark.cuda

DEV = "cuda"
# the headline's frame, and the frame of paths whose frame size is not
# what they check
FULL, SMALL = (1920, 1080), (320, 180)
CLEAN = {"truncated": 0, "nee_overflow": 0}
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "config1_256.npz")


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.fixture(scope="module")
def registry(card):
    return BlockRegistry.load("assets")


@pytest.fixture(scope="module")
def headline(card):
    return headline_setup(*FULL, 4, device=DEV)


@pytest.fixture(scope="module")
def general(card):
    return general_setup(*FULL, 4, device=DEV)


def sync():
    if torch.device(DEV).type == "cuda":
        torch.cuda.synchronize()


def hold_trace(arrays, o, d, events):
    """K1 on these rays, held to the plain march with and without its
    empty-space skips."""
    got = window_trace(arrays, o, d, events)
    limit = 1e-5 * o.x.shape[0]
    for aux in (arrays.aux_grid, arrays.aux_grid & 3):
        want = trace_plain(arrays._replace(aux_grid=aux), o, d, events)
        for g, w in zip(got, want):
            assert int((g != w).sum()) <= limit
    assert not bool(((got[0] >> 22) & 1).any()), "a ray was truncated"
    return got


def hold_shade(args, kw):
    """K2 on these inputs (args[8]: the radiance in), held to shade_plain."""
    got = shade_pass(*args, **kw)
    want = shade_plain(*args, **kw)
    bf16 = kw.get("color_bf16", False)
    for k, (gv, wv) in enumerate(zip(got, want)):
        for gc, wc, r in zip(gv, wv, args[8]):
            assert gc.dtype == wc.dtype and bool(torch.isfinite(gc).all())
            diff = (gc.double() - wc.double()).abs()
            if bf16 and k == 2:
                assert bool((diff <= bf16_ulp(wc)).all()), "tp"
            elif bf16 and k == 3:
                assert bool((diff <= bf16_ulp(wc - r)
                             + 1.2e-7 * wc.abs().clamp_min(1.0)).all())
            else:
                assert float(diff.max()) < 1e-3, f"output {k}"
                assert float(diff.pow(2).mean().sqrt()) < 1e-5, f"output {k}"
    return got


def hold_sweep(lights, point, normal, direction, mis, max_depth, max_hits):
    """S3 on these rays, held to `nee_sweep_plain`: the crossings and
    overflowing rays equal to the plain version's and to the crossing
    test's, a ray with one crossing or none bit for bit, one with more
    within NEE_REL; one launch.  A ray that leaves along its surface
    (cos_theta 0) and crosses a lamp has a pdf of t^2 / 0, infinite (NaN
    where its walk's probability is 0 too), which the throughput's MIS
    weight takes to 0: the kernel gives the same, and no other ray's pdf
    is not finite.  Returns (the rays, those that cross a light prim)."""
    args = (lights, *(V3(*(c.contiguous() for c in v))
                      for v in (point, normal, direction)),
            mis.contiguous(), max_depth, max_hits)
    counts = torch.zeros(2, dtype=torch.int64, device=mis.device)
    before = nee_sweep.launches
    got = nee_sweep(*args, counts)
    assert nee_sweep.launches == before + 1
    want_counts = torch.zeros_like(counts)
    want = wf.nee_sweep_plain(*args, want_counts)
    c = kernel_times.nee_stats(lights, point, direction, mis, max_depth)[0]
    assert counts.tolist() == want_counts.tolist() == [
        int(c.sum()), int((c > max_hits).sum())]
    _, nrm, d = args[1:4]
    cos = (nrm.x * d.x + nrm.y * d.y) + nrm.z * d.z
    odd = ~torch.isfinite(want)
    assert bool((cos[odd] == 0).all())
    same = (got == want) | (got.isnan() & want.isnan())
    assert bool(same[odd | (c <= 1)].all())
    got, want = got[~odd], want[~odd]
    assert bool(((got - want).abs() <= NEE_REL * want.abs()).all())
    return mis.shape[0], int((c > 0).sum())


def hold_walk(lights, point, normal, seed, active, max_depth):
    """S4 on these rays, held to `light_walk_plain`: success and prim
    equal on every ray, probability and importance bit for bit (NaN where
    the plain walk's is NaN); one launch."""
    before = light_walk.launches
    got = wf.traverse_light_bvh(lights, point, normal, seed, active,
                                max_depth)
    assert light_walk.launches == before + 1
    want = wf.light_walk_plain(lights, point, normal, seed, active,
                               max_depth)
    for field, g, w in zip(wf.BvhSample._fields, got, want):
        assert same_bits(g, w), field
    return got


def hold_calls(renderer, scene, basis, prefs, frame, bf16=False,
               sweeps=None) -> dict:
    """One frame of `renderer` (its primary cache read and filled) with
    every K1, K2, K3, S3 and S4 call held to its plain version on the
    inputs the frame loop hands it: the compaction buckets, the scene's
    event budget, the entity stream, the light set; with `bf16` K2's bf16
    build too, on the same rays with tp in bfloat16.  Returns the calls by
    kernel; `sweeps`, where given, gets `hold_sweep`'s (rays, crossing
    rays) of each S3 call."""
    arrays, kw, pkey, primary = renderer._frame_args(scene, basis, prefs)
    calls = {"trace": 0, "shade": 0, "texel": 0, "nee_sweep": 0,
             "light_walk": 0}
    sweeps = [] if sweeps is None else sweeps

    def trace(a, o, d, events):
        calls["trace"] += 1
        return hold_trace(a, o, d, events)

    def shade(*args, **skw):
        calls["shade"] += 1
        if bf16:
            tp16 = args[7].map(lambda c: c.to(torch.bfloat16))
            hold_shade(args[:7] + (tp16,) + args[8:],
                       {**skw, "color_bf16": True})
        return hold_shade(args, skw)

    def texel(atlas, tex, u, v, channels=None):
        calls["texel"] += 1
        got = texel_fetch(atlas, tex, u, v, channels=channels)
        assert torch.equal(got, texel_plain(atlas, tex, u, v,
                                            channels=channels))
        return got

    real = rr.nee_pdf_sweep

    def sweep(lights, point, normal, direction, mis, dense_probs, **skw):
        if dense_probs is None:
            calls["nee_sweep"] += 1
            sweeps.append(hold_sweep(lights, point, normal, direction, mis,
                                      skw["max_depth"], skw["max_hits"]))
        return real(lights, point, normal, direction, mis, dense_probs,
                    **skw)

    real_walk = rr.traverse_light_bvh

    def walk(*args):
        calls["light_walk"] += 1
        return hold_walk(*args)

    rr.nee_pdf_sweep, rr.traverse_light_bvh = sweep, walk
    try:
        img, aux = render_frame(arrays, basis.eye, basis.front, basis.right,
                                basis.up, frame, primary, **kw, trace=trace,
                                shade=shade, texel=texel)
    finally:
        rr.nee_pdf_sweep, rr.traverse_light_bvh = real, real_walk
    renderer._keep_primary(arrays, pkey, primary, aux)
    assert bool(torch.isfinite(img).all())
    assert {k: aux[k] for k in CLEAN} == CLEAN
    return calls


# ---- every kernel call of a frame ----


@pytest.mark.parametrize("path", ["headline", "general", "streamed",
                                  "lamps"])
def test_frame_calls_match_plain(headline, general, path):
    """Every K1 and K2 call of the headline frame and the streamed
    window's frame (1920x1080, 4 bounces; K2 also in its bf16 build), and
    every K1, K3, S3 and S4 call of the general frame and the lamp-lit
    window's (`lamps_setup`, the `lamps.orbit` cell's frame), on the
    inputs the frame loop hands them: S3's bounce 0 holds more rays than
    the card keeps resident at once, so its persistent grid strides past
    them; then K3 on seeded lanes at the frame's ray count: slots and
    coordinates past both edges, non-finite coordinates."""
    if path in ("streamed", "lamps"):
        setup = streamed_setup if path == "streamed" else lamps_setup
        scene, _, settings, basis, prefs = setup(*FULL, 4, device=DEV)
    else:
        scene, settings, basis, prefs = general if path == "general" \
            else headline
    fused = path in ("headline", "streamed")
    sweeps = []
    calls = hold_calls(Renderer(settings, device=DEV), scene, basis, prefs,
                       1, bf16=fused, sweeps=sweeps)
    nb = settings.num_bounces
    assert calls == {"trace": nb, "shade": nb * fused,
                     "texel": nb * (not fused),
                     "nee_sweep": nb * (not fused),
                     "light_walk": nb * (not fused)}
    if fused:
        return
    # a card holds at most 2048 threads an SM at once
    resident = torch.cuda.get_device_properties(DEV).multi_processor_count \
        * 2048
    assert sweeps[0][0] > resident and sweeps[0][1] > 10000
    atlas = scene.get_arrays().atlas_packed
    n = settings.n_rays
    g = torch.Generator().manual_seed(0)
    tex = torch.randint(-50, atlas.shape[0] + 50, (n,), generator=g,
                        dtype=torch.int32)
    uv = torch.rand((2, n), generator=g) * 1.2 - 0.1
    odd = torch.tensor([float("nan"), float("inf"), float("-inf"), 3e38,
                        -3e38, 1e10, -1e10])
    lanes = torch.randint(0, n, (2, 70000), generator=g)
    uv[0, lanes[0]] = odd.repeat(10000)
    uv[1, lanes[1]] = odd.repeat(10000).flip(0)
    args = (atlas, tex.to(DEV), uv[0].to(DEV), uv[1].to(DEV))
    assert torch.equal(texel_fetch(*args, channels=rr.CHANNELS),
                       texel_plain(*args, channels=rr.CHANNELS))


@pytest.mark.parametrize("config", [1, 2, 5])
def test_ladder_frames_match_plain(registry, config):
    """Every K1 and K2 call of a frame of ladder configs 1 and 2 (K2 at
    nee_type 0) and 5 (2560x1440, 8 bounces: a frame that fills the
    primary cache, then a cached one) against the plain versions; config
    1's and 5's batch of 8 equal to 8 single frames, and its accumulated
    mean to their sum in frame order over 8, bit for bit."""
    scene, _, settings, nee, basis = bench_ladder.build(config, registry,
                                                        DEV)
    basis = basis or bench_ladder.default_pose()
    prefs = RenderingPreferences(nee_type=nee)
    nb = settings.num_bounces
    r = Renderer(settings.replace(trace_audit=True), device=DEV)
    for frame in (1, 2)[:1 + settings.cache_primary]:
        cached = frame == 2
        assert hold_calls(r, scene, basis, prefs, frame) == {
            "trace": nb - cached, "shade": nb, "texel": 0, "nee_sweep": 0,
            "light_walk": 0}
    if config == 2:
        return
    single = Renderer(settings, device=DEV)
    singles = [single.render(scene, basis, prefs, frame_count=f,
                             as_numpy=False) for f in range(8)]
    batch = Renderer(settings, device=DEV)
    stack = batch.render_batch(scene, basis, prefs, frame_count=0, k=8,
                               as_numpy=False)
    assert torch.equal(stack, torch.stack(singles))
    mean = batch.render_batch(scene, basis, prefs, frame_count=0, k=8,
                              accumulate=True, as_numpy=False)
    total = singles[0]
    for img in singles[1:]:
        total = total + img
    assert torch.equal(mean, total / 8.0)


def test_golden_frame_on_the_card(registry):
    """The stored golden config-1 frame through the kernels, under the
    golden gate, rendered under the validation layer's NaN checks."""
    from wavefront_tpu_torch.utils.validation import (
        check_image,
        validation_layer,
    )

    blob = np.load(GOLDEN)
    w, h, bounces, nee_type, frame = (int(x) for x in blob["meta"])
    scene = VoxelScene(registry, config1_grid(registry), (0, 0, 0),
                       max_light_prims=256, device=DEV)
    settings = RenderSettings(width=w, height=h, num_bounces=bounces,
                              max_trace_steps=96)
    with validation_layer():
        got = Renderer(settings, device=DEV).render(
            scene, config1_pose(), RenderingPreferences(nee_type=nee_type),
            frame_count=frame)
    check_image(got, "the golden frame")
    golden_gate(got, blob["image"])


def test_kernels_keep_their_loads_in_registers(card):
    """K3's unrolled channel loop, K6's unrolled channel loops and K5's
    onehot forms (`loop_kernel<1..3,...>`) keep their loads in registers:
    the assembler reports no stack frame and no spill for any of them.
    (K5's `zsel_local` keeps its array in local memory on purpose.)"""
    _build.build_all()
    onehot = ("loop_kernel<1,", "loop_kernel<2,", "loop_kernel<3,")
    held = {"texel": _build.resource_usage("texel"),
            "extract_probe": _build.resource_usage("extract_probe"),
            "loop_probe": [k for k in _build.resource_usage("loop_probe")
                           if k["kernel"].startswith(onehot)]}
    for src, kernels in held.items():
        assert kernels, f"no assembler report for {src}"
        for k in kernels:
            assert k.get("stack") == k.get("spill_stores") \
                == k.get("spill_loads") == 0, (src, k)


# ---- launches ----


def launches() -> dict:
    return {k.split(".", 1)[1]: v for k, v in counters().items()
            if k.startswith("launches.")}


def launched(fn):
    """(fn(), the frame kernels' launches it made)."""
    before = launches()
    out = fn()
    sync()
    return out, {k: v - before[k] for k, v in launches().items()}


def rule(settings, prefs, fused, sparse=False, frames=1, cached=0,
         entities=False) -> dict:
    """The frame kernels' launches over `frames` frames, `cached` of them
    served from the primary cache, by record name: a K1 a traced bounce;
    on the fused path a K2 a bounce; on the general path a K3 a bounce
    and, on a sparse light set with NEE, an S3 and an S4; with entities
    an S5 a traced bounce; an S2 a sorted
    bounce
    (every bounce of a frame that sorts, `sort_bounces`' where given,
    never bounce 0 under the primary cache), with an S1 under
    `trace_presort`."""
    nb = settings.num_bounces
    bounces = nb * frames
    sorted_b = 0
    if settings.compaction or prefs.sort_type == 1:
        only = settings.sort_bounces
        sorted_b = frames * sum(1 for b in range(int(settings.cache_primary),
                                                 nb)
                                if only is None or b in only)
    sparse_nee = bounces if not fused and sparse and prefs.nee_type else 0
    return {"trace_kernel": bounces - cached,
            "shade_kernel": bounces if fused else 0,
            "texel_kernel": 0 if fused else bounces,
            "nee_sweep_kernel": sparse_nee,
            "light_walk_kernel": sparse_nee,
            "tri_sweep_kernel": bounces - cached if entities else 0,
            "ray_key_kernel": sorted_b if settings.trace_presort else 0,
            "ray_permute_kernel": sorted_b}


@pytest.mark.parametrize("path", ["headline", "headline_bf16", "general",
                                  "headline_batch", "general_batch"])
def test_launches_follow_the_rule(headline, general, path):
    """A frame of each main path launches what `rule` says; with the
    primary cache, a frame that fills it, a batch of 4 read from it, and
    a batch of 4 on a new renderer (its first frame fills it)."""
    scene, settings, basis, prefs = general if path.startswith("general") \
        else headline
    fused = path.startswith("headline")
    sparse = not scene.get_arrays().lights.dense
    ent = bool(scene._entities)
    if path == "headline_bf16":
        settings = settings.replace(shade_bf16=True)
    if not path.endswith("batch"):
        (_, aux), got = launched(lambda: Renderer(settings, device=DEV).render(
            scene, basis, prefs, frame_count=0, with_aux=True))
        assert aux == CLEAN
        assert got == rule(settings, prefs, fused, sparse, entities=ent)
        return
    settings = settings.replace(cache_primary=True)
    r = Renderer(settings, device=DEV)
    _, got = launched(lambda: r.render(scene, basis, prefs, frame_count=0))
    assert got == rule(settings, prefs, fused, sparse, entities=ent)
    _, got = launched(lambda: r.render_batch(scene, basis, prefs,
                                             frame_count=1, k=4))
    assert got == rule(settings, prefs, fused, sparse, frames=4, cached=4,
                       entities=ent)
    fresh = Renderer(settings, device=DEV)
    _, got = launched(lambda: fresh.render_batch(scene, basis, prefs,
                                                 frame_count=1, k=4))
    assert got == rule(settings, prefs, fused, sparse, frames=4, cached=3,
                       entities=ent)


@pytest.mark.parametrize("path", ["fused", "general"])
def test_use_entities_on_the_card(card, path, monkeypatch):
    """`render_frame(use_entities=...)` on a scene with the ego cube, on
    each shade path: False renders the entity-free frame bit for bit and
    sweeps no triangle, True sweeps once a bounce (an S5 launch) and shows
    the cube; every frame launches what `rule` says."""
    setup = headline_setup if path == "fused" else general_setup
    scene, settings, basis, prefs = setup(*SMALL, 4, device=DEV)
    if path == "general":
        scene.remove_object("ego")
    # the general path sweeps by triangle_sweep, the fused path by the
    # sweep's stream form
    swept = []
    for name in ("triangle_sweep", "entity_stream"):
        fn = getattr(rr, name)
        monkeypatch.setattr(rr, name, lambda *a, fn=fn, **kw:
                            swept.append(1) or fn(*a, **kw))
    sparse = not scene.get_arrays().lights.dense

    def frame(use):
        swept.clear()
        (img, aux), got = launched(lambda: render_frame(
            scene.get_arrays(), basis.eye, basis.front, basis.right,
            basis.up, 1, settings=settings, nee_type=prefs.nee_type,
            sort_type=prefs.sort_type, use_entities=use))
        assert aux == CLEAN
        assert got == rule(settings, prefs, path == "fused", sparse,
                           entities=use)
        return img, len(swept)

    free, _ = frame(False)
    add_ego_cube(scene, basis)
    off, off_sweeps = frame(False)
    on, on_sweeps = frame(True)
    assert (off_sweeps, on_sweeps) == (0, settings.num_bounces)
    assert torch.equal(off, free) and not torch.equal(on, free)


# ---- edits, recentres and the game against a fresh build ----


def assembled(cm) -> np.ndarray:
    """The chunk manager's window assembled from scratch from its chunks."""
    return cm._assemble(cm.chunks, cm.center_chunk, set())[0]


def hold_scene(scene, window) -> None:
    """The scene's device grid and aux grid equal its host grid and a
    fresh `make_aux_grid` of it, and the host grid `window`."""
    arrays = scene.get_arrays()
    want = make_aux_grid(scene.grid, scene._transparent, scene._translucent)
    assert np.array_equal(arrays.grid.cpu().numpy(), scene.grid)
    assert np.array_equal(scene._aux, want)
    assert np.array_equal(arrays.aux_grid.cpu().numpy(), want)
    assert tuple(arrays.grid_origin) == tuple(scene.grid_origin)
    assert np.array_equal(scene.grid, window)


def hold_fresh(img, scene, settings, basis, prefs, frame) -> None:
    """`img` equals bit for bit the frame of a new renderer on a scene
    built afresh from `scene`'s host grid, origin and entities."""
    fresh = VoxelScene(scene.registry, scene.grid.copy(), scene.grid_origin,
                       max_light_prims=scene.max_light_prims,
                       max_entity_tris=scene.max_entity_tris, device=DEV)
    for key, (v, u, t, m) in scene._entities.items():
        fresh.add_object(key, v, u, t, transform=m)
    want = Renderer(settings, device=DEV).render(fresh, basis, prefs,
                                                 frame_count=frame,
                                                 as_numpy=False)
    assert torch.equal(torch.as_tensor(img, device=want.device), want)


def edited(registry, scene, cm, renderer, basis, prefs):
    """Five frames, each after a block edit through the chunk manager
    (stone and air in turn); returns the last and its frame count."""
    stone = registry.block_idx("stone")
    for f in range(1, 6):
        cm.set_block((8 + f % 16, 30, 3), stone if f % 2 else registry.air)
        img, aux = renderer.render(scene, basis, prefs, frame_count=f,
                                   as_numpy=False, with_aux=True)
        assert aux == CLEAN
    return img, 5


def recentred(registry, scene, cm, renderer, basis, prefs):
    """The centre moved one chunk along +x, its chunks made, the window
    rebuilt in the background while frames are served on the old one,
    then adopted; returns the first frame on the new window and its frame
    count."""
    renderer.render(scene, basis, prefs, frame_count=0)
    origin = tuple(scene.grid_origin)
    cx, cy, cz = cm.center_chunk
    cm.center_chunk = (cx + 1, cy, cz)
    for key in cm._window_keys(cm.center_chunk):
        cm._request_chunk(key)
    cm._window_dirty = True
    cm._async_rebuild_opt = True
    cm._submit_rebuild()
    while not cm._rebuild_job.done():
        assert renderer.render(scene, basis, prefs, frame_count=90,
                               as_numpy=False, with_aux=True)[1] == CLEAN
    cm._adopt_rebuild()
    img, aux = renderer.render(scene, basis, prefs, frame_count=89,
                               as_numpy=False, with_aux=True)
    assert aux == CLEAN
    assert tuple(scene.grid_origin) == (origin[0] + 32, *origin[1:])
    return img, 89


def ego_spot(world, registry) -> np.ndarray:
    """Where to put the game's ego for its mouse ray, inside chunk
    (0, 0, 0): the first column (x, *, z), z then x from (8, *, 0), whose
    highest solid below y = 29 has 8 voxels of air above it and from 1.5
    above which the camera's centre ray meets a block within the ray's
    reach (the terrain is 3-D noise, so a fixed spot may sit inside it)."""
    q, cam = world.chunk_querier, world.camera
    solid = np.asarray(registry.solid, bool)
    for z, x in ((z, x) for z in range(32) for x in range(8, 32)):
        for y in range(28, -3, -1):
            ids = q.get_blocks(np.array([(x, y + k, z) for k in range(9)]))
            s = (ids >= 0) & solid[np.clip(ids, 0, len(solid) - 1)]
            if s[0] and not s[1:].any():
                pos = np.array([x + 0.5, y + 2.5, z + 0.5])
                cam.set_root_position(pos)
                basis = cam.eye_front_right_up()
                if q.trace_to_solid(basis.eye, basis.front, 10.0):
                    return pos
                break
    raise AssertionError("no spot where the mouse ray meets a block")


def played(registry):
    """`GameWorld` on the load-radius window (13x3x13 chunks of 32^3) with
    a dynamic ego cube, chunks made and the window rebuilt on the calling
    thread: a loading step, then 10 steps, launching what `rule` says,
    with a `WorldSetBlock` (step 2), the ego moved where its mouse ray
    meets a block (3) and that block broken (4, 5), and the ego moved
    across a chunk border (7), which recentres the window.  Returns the
    world, its last image and that image's frame count."""
    settings = RenderSettings(width=SMALL[0], height=SMALL[1],
                              num_bounces=4, max_trace_steps=192,
                              trace_audit=True, compaction=True)
    world = GameWorld(registry, settings=settings, window_chunks=None,
                      headless=False, device=DEV)
    cm, pm, ego = world.managers[:3]
    cm.synchronous = True
    world.camera.set_rendering_preferences(RenderingPreferences(nee_type=1))
    world.camera.pitch = -0.8
    verts, uv, tex = meshes.unitcube()
    lo, hi = meshes.mesh_aabb(verts)
    world.add_entity(0, EntityCreationData(
        mesh=Mesh(verts, uv, tex), isometry=translation(8.0, 6.0, 0.5),
        physics=EntityPhysicsData(
            rigid_body_type="dynamic", half_extents=(hi - lo) / 2,
            linvel=np.zeros(3), angvel=np.zeros(3), controlled=True)))
    audits = []
    world.step()
    audits.append(world.last_aux)
    origin = tuple(world.scene.grid_origin)
    stone = registry.block_idx("stone")
    placed, target = (5, 20, 5), None

    def move_ego(pos):
        world.entities[0].isometry = translation(*pos)
        pm.bodies[0].pos = np.asarray(pos, np.float64)
        pm.bodies[0].linvel[:] = 0.0

    def steps():
        nonlocal target
        for i in range(1, 11):
            if i == 2:
                world.changes_since_last_step.append(
                    WorldSetBlock(np.array(placed), stone))
            if i == 3:
                move_ego(ego_spot(world, registry))
            if i == 4:
                # the mouse ray at the screen centre from the ego's pose
                cam = world.camera
                cam.set_root_position(world.entities[0].isometry[:, 3])
                basis = cam.eye_front_right_up()
                hit = world.chunk_querier.trace_to_solid(basis.eye,
                                                         basis.front, 10.0)
                assert hit is not None
                target = hit[0]
                ego.last_broke -= 1.0
                world.handle_window_event(Event(
                    "mouse_move", x=settings.width / 2,
                    y=settings.height / 2))
                world.handle_window_event(Event("mouse_down", button="left"))
            if i == 5:
                world.handle_window_event(Event("mouse_up", button="left"))
            if i == 7:
                move_ego((40.5, 6.0, 0.5))
            world.step()
            audits.append(world.last_aux)

    _, got = launched(steps)
    assert got == rule(settings, world.camera.rendering_preferences(), True,
                       frames=10, entities=True)
    assert audits == [CLEAN] * 11
    for q in (world.chunk_querier, world.scene):
        assert q.get_block(np.array(placed)) == stone
        assert q.get_block(np.array(target)) == registry.air
    assert tuple(world.scene.grid_origin) == (origin[0] + 32, *origin[1:])
    return world, world.last_image, world.frame_count - 1


@pytest.mark.parametrize("case", ["streamed_edit", "recenter", "game"])
def test_world_matches_a_fresh_build(registry, case):
    """The streamed window (13x3x13 chunks of 32^3) after a block edit a
    frame through the chunk manager, after a recentre through the
    background rebuild (6 bounces), and in the game after its edits and
    recentre: its device grid and aux grid equal a fresh build and the
    window assembled from scratch, and its last frame equals bit for bit
    a fresh scene's."""
    if case == "game":
        world, img, frame = played(registry)
        scene, cm, settings = world.scene, world.managers[0], world.settings
        basis = world.camera.eye_front_right_up()
        prefs = world.camera.rendering_preferences()
    else:
        scene, cm, settings, basis, prefs = streamed_setup(
            *SMALL, 4 if case == "streamed_edit" else 6, device=DEV)
        step = edited if case == "streamed_edit" else recentred
        img, frame = step(registry, scene, cm,
                          Renderer(settings, device=DEV), basis, prefs)
    hold_scene(scene, assembled(cm))
    hold_fresh(img, scene, settings, basis, prefs, frame)


# ---- the app, its viewer and checkpoints ----


def settle(world) -> None:
    """Finish the world's chunk loading on the frame thread, and load
    and rebuild there from then on."""
    cm = world.managers[0]
    for f in list(cm._pending.values()):
        f.result()
    cm._drain_pending()
    cm.flush_rebuild()
    cm.synchronous = True
    cm._async_rebuild_opt = False


def test_app_viewer_and_checkpoint(registry, tmp_path, monkeypatch):
    """The app on the card: 4 frames of the scripted fly-through with a
    screenshot every 2, and every K1 and K2 (or K3) call of a frame of
    its final scene, the ego's entity stream with it, against the plain
    versions; 4 frames of `--accumulate --hold` whose frames after the
    first reuse the primary hits (a K1 launch fewer); its frame over the
    viewer (`GET /frame`: the JPEG of `_encode`, its 16x16 block means at
    a PSNR of 35 dB or more against the frame); a checkpoint of its world
    loaded into a new one: device grid, aux grid and a frame equal."""
    from PIL import Image

    import wavefront_tpu_torch.app.main as app
    from wavefront_tpu_torch.app.viewer import Viewer
    from wavefront_tpu_torch.render.screenshot import read_png, to_srgb_bytes
    from wavefront_tpu_torch.utils.persistence import load_world, save_world

    worlds, build = [], app.build_world

    def capture(args):
        world = build(args)
        world.screenshot_dir = str(tmp_path / f"shots{len(worlds)}")
        # held still, the world loads on the frame thread, so its first
        # step loads the whole window
        world.managers[0].synchronous = args.hold
        steps, step = [], world.step

        def counted():
            before = launches()["trace_kernel"]
            step()
            steps.append((launches()["trace_kernel"] - before,
                          world.scene.get_arrays()))

        world.step = counted
        worlds.append((world, args, steps))
        return world

    monkeypatch.setattr(app, "build_world", capture)
    side = 256
    run = ["--width", str(side), "--height", str(side), "--frames", "4",
           "--device", DEV]
    app.main(run + ["--screenshot-every", "2"])
    app.main(run + ["--accumulate", "--hold"])
    (world, args, _), (_, _, held) = worlds
    nb = world.settings.num_bounces
    shots = sorted(os.listdir(world.screenshot_dir))
    assert shots == ["0.png", "1.png"]
    for f in shots:
        with open(os.path.join(world.screenshot_dir, f), "rb") as fh:
            assert read_png(fh.read()).shape == (side, side, 3)
    img = world.last_image
    assert np.isfinite(img).all() and img.mean() > 0.0
    basis = world.camera.eye_front_right_up()
    prefs = world.camera.rendering_preferences()
    calls = hold_calls(Renderer(world.settings, device=DEV), world.scene,
                       basis, prefs, world.frame_count)
    assert calls["trace"] == nb and calls["shade"] + calls["texel"] == nb
    reused = [i > 0 and arrays is held[i - 1][1]
              for i, (_, arrays) in enumerate(held)]
    assert [k for k, _ in held] == [nb - r for r in reused]
    assert sum(reused) == 3

    v = Viewer(port=0)
    try:
        v.publish(img)
        r = urllib.request.urlopen(f"http://127.0.0.1:{v.port}/frame",
                                   timeout=60)
        body = r.read()
        assert r.headers["Content-Type"] == "image/jpeg"
        assert body == v._encode()
    finally:
        v.close()
    got = np.asarray(Image.open(io.BytesIO(body)).convert("RGB"), np.float64)
    want = to_srgb_bytes(img).astype(np.float64)
    assert got.shape == want.shape

    def blocks(x):
        return x[:side, :side].reshape(side // 16, 16, side // 16, 16,
                                       3).mean((1, 3))

    err = float(((blocks(got) - blocks(want)) ** 2).mean())
    assert 10.0 * np.log10(255.0 ** 2 / max(err, 1e-12)) >= 35.0

    world.handle_window_event(Event("key_up", key="w"))
    settle(world)
    world.step()
    stone = registry.block_idx("stone")
    spot = np.floor(world.entities[0].isometry[:, 3]).astype(np.int64) \
        + np.array([2, -1, 2])
    world.changes_since_last_step.append(WorldSetBlock(spot, stone))
    world.step()
    assert world.scene.get_block(tuple(spot)) == stone
    path = str(tmp_path / "world.npz")
    save_world(world, path)
    fresh = build(args)
    load_world(fresh, path)
    fresh.managers[0].synchronous = True
    fresh.step()
    a, b = world.scene.get_arrays(), fresh.scene.get_arrays()
    assert tuple(a.grid_origin) == tuple(b.grid_origin)
    assert torch.equal(a.grid, b.grid) and torch.equal(a.aux_grid, b.aux_grid)
    assert fresh.scene.get_block(tuple(spot)) == stone
    frames = [Renderer(world.settings, device=DEV).render(
        s, world.camera.eye_front_right_up(), prefs,
        frame_count=world.frame_count, as_numpy=False)
        for s in (world.scene, fresh.scene)]
    assert torch.equal(*frames)


# ---- sort schedules, sort utilities, the histogram ----


@pytest.fixture(scope="module")
def every_bounce(headline):
    scene, settings, basis, prefs = headline
    return Renderer(settings, device=DEV).render(scene, basis, prefs,
                                                 frame_count=1,
                                                 as_numpy=False)


@pytest.mark.parametrize("row", ["b1-b2", "b1-b3", "b1", "none", "nosort",
                                 "dda"])
def test_schedules_keep_the_image(headline, every_bounce, row):
    """The headline frame under each `sort_bounces` schedule of
    `tools/sort_sweep.py`, and with no sort at all (`nosort`: no presort,
    no compaction), within 1e-5 of the every-bounce sort's image; with
    K1's unskipped march (`dda`: `trace_skips=False`, 512 steps) under
    the golden gate of it; no ray truncated."""
    scene, settings, basis, prefs = headline
    if row == "nosort":
        settings = settings.replace(trace_presort=False, compaction=False)
    elif row == "dda":
        settings = settings.replace(trace_skips=False, max_trace_steps=512)
    else:
        settings = settings.replace(
            sort_bounces=dict(sort_sweep.SCHEDULES)[row])
    img, aux = Renderer(settings, device=DEV).render(
        scene, basis, prefs, frame_count=1, as_numpy=False, with_aux=True)
    assert aux == CLEAN
    if row == "dda":
        golden_gate(img, every_bounce)
    else:
        assert float((img - every_bounce).abs().max()) \
            <= sort_sweep.IMAGE_TOLERANCE


def test_sort_utilities_match_numpy(card):
    """The six sort utilities on the headline's 2,073,600 seeded 32-bit
    keys (int64 on the card) equal numpy's stable argsort, cumsum and
    per-partition bincount."""
    from wavefront_tpu_torch.kernels import sort

    n, part = 1920 * 1080, 1024
    keys_np = np.random.RandomState(0x5EED).randint(
        0, 2 ** 32, size=n, dtype=np.uint64).astype(np.uint32)
    keys = torch.as_tensor(keys_np.astype(np.int64), device=DEV)
    small_np = (keys_np & 0xFF).astype(np.int32)
    small = torch.as_tensor(small_np, device=DEV)
    order = np.argsort(keys_np, kind="stable")
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n)
    rows = np.arange(n) // part
    hist = np.bincount(rows * 256 + ((keys_np >> 8) & 0xFF),
                       minlength=(n // part) * 256).reshape(n // part, 256)
    calls = {
        "sort_keys": (sort.sort_keys(keys), np.sort(keys_np)),
        "sort_key_value": (sort.sort_key_value(keys, torch.arange(
            n, dtype=torch.int32, device=DEV)), (keys_np[order], order)),
        "sort_permutation": (sort.sort_permutation(keys), order),
        "invert_permutation": (sort.invert_permutation(torch.as_tensor(
            order, device=DEV)), inv),
        "exclusive_scan": (sort.exclusive_scan(small),
                           np.cumsum(small_np, dtype=np.int32) - small_np),
        "segmented_histogram": (sort.segmented_histogram(keys, part, 8, 8),
                                hist),
    }
    for name, (got, want) in calls.items():
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            assert np.array_equal(g.cpu().numpy().astype(np.int64),
                                  np.asarray(w).astype(np.int64)), name


def test_histogram_calls_are_one_device_operation(headline):
    """Each call of K4 (one digit, one read of four, `radix_hist` in one
    read) on the headline's seeded keys and its frame's coherence keys is
    at most two device operations, as torch.profiler records them: the
    histogram kernel and no fill of its own."""
    calls = (lambda k: rh.digit_histogram(k, 0), rh.digit_histograms4,
             lambda k: rh.radix_hist(k, one_read=True))
    for keys in kernel_times.radix_keys(*headline[:3]).values():
        for call in calls:
            _, ops, _ = kernel_times.radix_device(lambda: call(keys), 20)
            assert ops is not None and ops <= 2

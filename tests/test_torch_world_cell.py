"""The game's step as the benchmark's `world.orbit` cell runs it
(`benchmark/configs/world_r6_1080p4.py`: `app/main.py::build_world`,
`GameWorld.step`), on the CPU at small sizes.

A 32x18 step of a small window (5x3x5 chunks) with the ego cube matches
the benchmark's reference (`benchmark/reference`) pixel for pixel, where
the bfloat16 color pipeline does not; the step hands out its audit when
its renderer is asked for one; it names its managers in `world.*` spans
in pipeline order inside `world.managers`, and the entity table's update
after them; the chunk manager's counters read 0 for a player holding
still and count the chunks, the rebuild and the edit of a step that
makes them; each frame counts the active triangles its sweeps tested.
The triangle sweep's kernel (S5) takes CUDA tensors only, in either
form: on CPU tensors `triangle_sweep` is the plain sweep, the only place
that gathers the pool on the host (`sync.tri_pool`), and `entity_attrs`
its plain stream; the bytes and operations
`tools/kernel_times.py` bounds S5 by are the benchmark's; and the ego's
mouse pick (`ChunkManager.trace_to_solid`) finds what the step-by-step
march finds.  The kernel
itself is held to the plain sweep on the card (tests/test_torch_tri_sweep.py).
"""

import argparse
import ast
import importlib
import pathlib

import numpy as np
import pytest
import torch
from _torch_threads import one_thread  # noqa: F401
from torch.profiler import ProfilerActivity, profile

from benchmark.harness import check, spec
from wavefront_tpu_torch.app.main import build_world
from wavefront_tpu_torch.core.vec3 import V3
from wavefront_tpu_torch.kernels.tri_sweep import entity_stream, tri_sweep
from wavefront_tpu_torch.render import renderer as rr
from wavefront_tpu_torch.render.intersect import (
    triangle_sweep,
    triangle_sweep_plain,
)
from wavefront_tpu_torch.tools import kernel_times
from wavefront_tpu_torch.utils import spans
from wavefront_tpu_torch.utils.profiling import counters
from wavefront_tpu_torch.world.game_world import WorldSetBlock, translation

CELL = "world.orbit"
# the benchmark's limit on the cell's off_share (limits/world.orbit.json)
LIMIT = 0.1
WINDOW = (2, 1, 2)
CLEAN = {"truncated": 0, "nee_overflow": 0}
PORT = pathlib.Path(__file__).resolve().parent.parent / "wavefront_tpu_torch"


def small_world(audit: bool = True):
    """`build_world` as the cell calls it, at 32x18 on a 5x3x5-chunk
    window, loaded and rebuilt on the calling thread."""
    cfg = spec.load_cell(CELL).config
    world = build_world(argparse.Namespace(
        width=32, height=18, bounces=cfg["num_bounces"],
        max_steps=cfg["max_trace_steps"], nee_type=cfg["nee_type"],
        sort_type=0, window_chunks=WINDOW, assets=None, headless=False,
        device="cpu", accumulate=False, drop_cubes=0, trace_audit=audit))
    cm = world.managers[0]
    cm.synchronous, cm._async_rebuild_opt = True, False
    world.step()
    return world


@pytest.fixture(scope="module")
def world():
    torch.set_num_threads(1)
    return small_world()


@pytest.fixture(scope="module")
def reference():
    """The cell's reference, from its own configuration at the small
    window's sizes."""
    cell = spec.load_cell(CELL)
    cs = cell.config["chunk_size"]
    cfg = {**cell.config,
           "grid": [(2 * w + 1) * cs for w in WINDOW],
           "grid_origin": [-w * cs for w in WINDOW]}
    return cell.build.reference(cfg, str(PORT.parent / "assets"), "cpu")


def off_share(world, reference, frames: int = 2) -> float:
    """off_share (harness/check.py) of every pixel of `frames` steps, each
    at its own yaw and frame count."""
    ref, basis = reference
    w, h = world.settings.width, world.settings.height
    pix = np.arange(w * h)
    off = lit = 0
    for i in range(frames):
        yaw, fc = 0.3 + 0.01 * i, 3_000_000_019 + i
        world.camera.yaw, world.frame_count = yaw, fc
        world.step()
        assert world.last_aux == CLEAN
        o, d = ref.rays(pix, w, h, basis(yaw))
        want = ref.paths(o, d, pix, np.full(len(pix), fc),
                         world.settings.num_bounces,
                         world.camera.rendering_preferences().nee_type)
        o_, l_ = check.off_lit(world.last_image.reshape(-1, 3),
                               want.numpy())
        off, lit = off + o_, lit + l_
    assert lit > 200 * frames
    return off / lit


def test_step_matches_the_reference_and_bf16_does_not(world, reference):
    assert tuple(world.entities[0].isometry[:, 3]) == \
        tuple(spec.load_cell(CELL).config["ego"]["translation"])
    share = off_share(world, reference)
    assert share < LIMIT / 5
    settings = world.renderer.settings
    world.renderer.settings = settings.replace(shade_bf16=True)
    try:
        assert off_share(world, reference, 1) > LIMIT > share
    finally:
        world.renderer.settings = settings


def test_step_hands_out_its_audit(world):
    world.step()
    assert world.last_aux == CLEAN
    bare = small_world(audit=False)
    bare.step()
    assert bare.last_aux is None and bare.last_image.shape == (18, 32, 3)


def _names(prof):
    """(name, start, end) of the session's `world.*` spans, in order of
    their start."""
    out = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith("world.")]
    return sorted(out, key=lambda x: x[1])


def test_manager_spans_in_pipeline_order(world):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        world.step()
    got = _names(prof)
    assert [n for n, _, _ in got] == [
        "world.managers", "world.chunk", "world.physics", "world.ego",
        "world.scene", "world.entity_table"]
    _, lo, hi = got[0]
    assert all(lo <= a <= b <= hi for _, a, b in got[1:5])
    assert got[5][1] >= hi


def _step(world):
    before = counters()
    world.step()
    after = counters()
    return {k: after[k] - before[k] for k in after}


def test_chunk_counters_still_and_moved():
    """A player holding still: no chunk requested, adopted, evicted or
    rebuilt and no edit, and the frame counts its 4 sweeps of the cube's
    12 triangles.  A step after the ego crosses a chunk border and a
    block is set: the new column of chunks requested and adopted, one
    rebuild, one edit."""
    world = small_world()
    still = _step(world)
    assert {k: still[k] for k in spans.WORLD_COUNTERS} == dict.fromkeys(
        spans.WORLD_COUNTERS, 0)
    assert still["entity_tris"] == 12 * world.settings.num_bounces
    pos = (40.5, 5.0, 0.5)
    world.entities[0].isometry = translation(*pos)
    body = world.managers[1].bodies[0]
    body.pos = np.asarray(pos, np.float64)
    body.linvel[:] = 0.0
    world.changes_since_last_step.append(WorldSetBlock(np.array((3, 20, 3)),
                                                       1))
    moved = _step(world)
    column = (2 * WINDOW[1] + 1) * (2 * WINDOW[2] + 1)
    assert moved["chunks_requested"] == moved["chunks_adopted"] == column
    assert moved["window_rebuilds"] == 1 and moved["block_edits"] == 1
    assert moved["chunks_evicted"] == 0


def test_cpu_sweep_is_the_plain_sweep():
    """On CPU tensors `triangle_sweep` is `triangle_sweep_plain`, with its
    host sync and its count; the kernel's wrapper refuses them."""
    g = np.random.default_rng(3)
    verts = torch.as_tensor(g.uniform(-1, 1, (64, 3, 3)), dtype=torch.float32)
    active = torch.as_tensor(g.random(64) < 0.5)
    o = V3.from_array(torch.as_tensor(g.uniform(-3, 3, (500, 3)),
                                      dtype=torch.float32))
    d = V3.from_array(torch.as_tensor(g.normal(size=(500, 3)),
                                      dtype=torch.float32))
    counts = [torch.zeros(1, dtype=torch.int64) for _ in "ab"]
    syncs, launches = spans.host_syncs, tri_sweep.launches
    got = triangle_sweep(verts, active, o, d, counts=counts[0])
    assert spans.host_syncs == syncs + 1
    want = triangle_sweep_plain(verts, active, o, d, counts=counts[1])
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert int(got.hit.sum()) > 0
    assert counts[0].item() == counts[1].item() == int(active.sum())
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tri_sweep(verts, active, o, d, 1e-3, 1e3)
    # the stream form: entity_attrs on CPU tensors is its plain version
    arrays = small_world().scene.get_arrays()
    pa = torch.zeros(500, dtype=torch.int32)
    t = torch.full((500,), 2.0)
    got_t, got = rr.entity_attrs(arrays, o, d, pa, t)
    want_t, want = rr.entity_attrs_plain(arrays, o, d, pa, t)
    assert torch.equal(got_t, want_t) and len(got) == 12
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        entity_stream(arrays.tri_verts, arrays.tri_active, arrays.tri_uv,
                      arrays.tri_tex, 1, o, d, pa, t, 1e-3, 1e3)
    assert tri_sweep.launches == launches


def test_tri_pool_sync_is_the_plain_sweeps_only():
    """`sync.tri_pool` is opened in `triangle_sweep_plain` and nowhere
    else in the port."""
    where = set()
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text())
        for fn in ast.walk(tree):
            if not isinstance(fn, ast.FunctionDef):
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Constant) \
                        and node.value == "sync.tri_pool":
                    where.add((path.name, fn.name))
    assert where == {("intersect.py", "triangle_sweep_plain")}


def test_kernel_times_s5_counts_are_the_benchmarks():
    """The bytes and operations `kernel_times` bounds S5 by equal the
    benchmark's (`metrics/tri_sweep_roofline.py`), at the rates it divides
    them by; and the tool takes the kernel."""
    m = importlib.import_module("benchmark.metrics.tri_sweep_roofline")
    rates = kernel_times.rates()
    assert rates.UNFUSED_OPS_PER_S == m.OPS_PER_S
    assert rates.HBM_BYTES_PER_S == m.peaks.HBM_BYTES_PER_S
    for n, slots, live in ((1, 64, 0), (4099, 64, 12),
                           (2_073_600, 64, 12), (2_073_600, 700, 350)):
        for stream in (False, True):
            assert kernel_times.tri_sweep_bytes(n, slots, stream) \
                == m.s5_bytes(n, slots, stream)
            assert kernel_times.tri_sweep_ops(n, live, stream) \
                == m.s5_ops(n, live, stream)
            ms, _ = kernel_times.tri_sweep_bound_ms(n, slots, live, stream)
            assert ms == pytest.approx(
                1e3 * m.s5_bound_s(n, slots, live, stream), rel=1e-12)
    args = kernel_times.parse(["--kernels", "tri_sweep"])
    assert args.kernels == ["tri_sweep"] and "tri_sweep" in \
        kernel_times.KERNELS


def stepwise_trace(cm, origin, direction, radius: float):
    """The reference's march (chunk_manager.rs:394-443), one numpy step
    at a time."""
    from wavefront_tpu_torch.world import chunk as chunk_mod

    step = 0.01
    direction = np.asarray(direction, np.float64)
    direction = direction / np.linalg.norm(direction) * step
    origin = np.asarray(origin, np.float64)
    loc = origin.copy()
    quant = chunk_mod.floor_coords(loc)
    for _ in range(int(radius / step) + 2):
        while np.array_equal(quant, chunk_mod.floor_coords(loc)):
            loc = loc + direction
            if ((loc - origin) ** 2).sum() > radius * radius:
                return None
        quant = chunk_mod.floor_coords(loc)
        block = cm.get_block(quant)
        if block is None:
            return None
        if block < len(cm.registry.solid) and cm.registry.solid[block]:
            delta = quant - chunk_mod.floor_coords(loc - direction)
            if delta[0] == -1:
                face = 1
            elif delta[0] == 1:
                face = 0
            elif delta[1] == -1:
                face = 3
            elif delta[1] == 1:
                face = 2
            elif delta[2] == -1:
                face = 5
            else:
                face = 4
            return tuple(int(x) for x in quant), face
    return None


def test_trace_to_solid_is_the_stepwise_march(world):
    """The ego's mouse pick (`ChunkManager.trace_to_solid`) finds the
    block and face the step-by-step march finds, or none where it finds
    none, on seeded rays that meet the terrain, leave the window or run
    out of radius, at the cell's radius and others."""
    cm = world.managers[0]
    g = np.random.default_rng(12)
    hits = 0
    for i in range(300):
        origin = g.uniform([-40.0, -10.0, -40.0], [40.0, 30.0, 40.0])
        direction = g.normal(size=3)
        if i % 3 == 0:
            direction[1] = -abs(direction[1]) - 0.5
        radius = (10.0, 3.0, 25.0)[i % 3]
        got = cm.trace_to_solid(origin, direction, radius)
        assert got == stepwise_trace(cm, origin, direction, radius)
        hits += got is not None
    assert 50 < hits < 250

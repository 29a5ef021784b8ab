"""The frame path's spans and counters (`utils/spans.py`, with
`utils/profiling.py::counters()`): `span`, `host_sync`, the counters,
and the readers that sum a profiler's device events.

On a one-chunk worldgen scene at 16x16, 4 bounces, compaction and the
trace audit on: `Renderer.render` counts 6 host syncs (4 compaction
counts, the audit read, the image copy), `render_batch(k=4,
accumulate=True)` with the primary cache 17 (3 counts and the audit
each frame, one copy); the ray slots are the buckets the compaction
chose and the alive rays their counts, on the bounces where the host
holds that count.  Every span name the port opens is registered in
`SPAN_NAMES`.  Under a CPU torch.profiler
session the spans nest as the frame runs them, with one `sync.*` span
for each counted sync; with no session recording no `record_function`
is made, and the images are the same bit for bit either way.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from wavefront_tpu_torch.core.camera import SphericalCamera
from wavefront_tpu_torch.core.config import (
    RenderingPreferences,
    RenderSettings,
    WorldSettings,
)
from wavefront_tpu_torch.headline import build_scene, general_setup
from wavefront_tpu_torch.render import renderer as rr
from wavefront_tpu_torch.render.scene import VoxelScene
from wavefront_tpu_torch.utils import spans as spans_mod
from wavefront_tpu_torch.utils.profiling import (
    SPAN_NAMES,
    StageTimer,
    counters,
    device_events,
    host_sync,
    span,
)
from wavefront_tpu_torch.utils.validation import validation_layer
from wavefront_tpu_torch.world.blocks import BlockRegistry

ASSETS = "assets"
FRAME = RenderSettings(width=16, height=16, num_bounces=4, compaction=True,
                       trace_audit=True)
PREFS = RenderingPreferences(nee_type=1)


@pytest.fixture(scope="module")
def chunk():
    reg = BlockRegistry.load(ASSETS)
    grid, origin = build_scene(reg, WorldSettings(), span=0)
    scene = VoxelScene(reg, grid, origin, max_light_prims=1024, device="cpu")
    cam = SphericalCamera()
    cam.set_root_position([16.0, 12.0, 16.0])
    cam.offset = 10.0
    cam.yaw = 0.6
    cam.pitch = -0.3
    return scene, cam.eye_front_right_up()


def single(chunk, settings=FRAME):
    scene, basis = chunk
    return rr.Renderer(settings, device="cpu").render(scene, basis, PREFS,
                                                      frame_count=5)


def batch(chunk):
    scene, basis = chunk
    return rr.Renderer(FRAME.replace(cache_primary=True),
                       device="cpu").render_batch(scene, basis, PREFS,
                                                  frame_count=5, k=4,
                                                  accumulate=True)


def delta(fn):
    before = counters()
    out = fn()
    after = counters()
    return out, {k: after[k] - before[k] for k in after}


def recorded(fn):
    """fn's result and the user spans (name, start, end) of a CPU
    torch.profiler session around it, with the counters' deltas."""
    prof = profile(activities=[ProfilerActivity.CPU])
    # started and stopped as the benchmark's session and `device_trace`
    # do, not entered
    prof.start()
    try:
        out, d = delta(fn)
    finally:
        prof.stop()
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if str(e.activity_type()) == "user_annotation")
    # a profiler whose events carry no activity type tells the program's
    # spans by these names
    assert {n for _, _, n in spans} <= set(SPAN_NAMES)
    return out, d, spans


def inside(spans, name, outer):
    """Whether every `name` span lies in some `outer` span."""
    outs = [(a, b) for a, b, n in spans if n == outer]
    return all(any(oa <= a and b <= ob for oa, ob in outs)
               for a, b, n in spans if n == name)


@pytest.mark.parametrize("what, syncs", [("render", 6), ("batch", 17)])
def test_sync_counts(chunk, monkeypatch, what, syncs):
    """The host syncs a call counts, and its ray slots and alive rays:
    every bounce of these frames either sorts and compacts (the bucket
    and its count) or is bounce 0 of the primary cache (all rays
    alive)."""
    buckets = []
    real = rr.compaction_bucket

    def spy(alive, sorted_now):
        m, count = real(alive, sorted_now)
        assert sorted_now and count == int(alive.sum())
        buckets.append((count, m))
        return m, count

    monkeypatch.setattr(rr, "compaction_bucket", spy)
    _, d = delta(lambda: single(chunk) if what == "render" else batch(chunk))
    assert d["host_syncs"] == syncs
    n = FRAME.render_width * FRAME.render_height
    cached = 4 if what == "batch" else 0    # bounce 0 of each frame
    assert len(buckets) == (12 if what == "batch" else 4)
    assert d["ray_slots"] == sum(m for _, m in buckets) + cached * n
    assert d["rays_alive"] == sum(a for a, _ in buckets) + cached * n
    assert 0 < d["rays_alive"] < d["ray_slots"]
    assert all(d[k] == 0 for k in d if k.startswith("launches."))


NESTING = [  # (span, the span it lies in)
    ("renderer.prepare", "renderer.render"),
    ("render.frame", "renderer.render"),
    ("sync.image_copy", "renderer.render"),
    ("render.raygen", "render.frame"),
    ("render.bounce", "render.frame"),
    ("render.sort_key", "render.bounce"),
    ("render.permute", "render.bounce"),
    ("render.compact", "render.bounce"),
    ("sync.compaction_count", "render.compact"),
    ("render.k1_trace", "render.bounce"),
    ("render.k2_shade", "render.bounce"),
    ("render.merge", "render.bounce"),
    ("sync.audit", "render.frame"),
    ("render.restore", "render.frame"),
    ("render.postprocess", "render.frame"),
]


def test_spans_nest_and_name_every_sync(chunk):
    _, d, spans = recorded(lambda: single(chunk))
    names = {n for _, _, n in spans}
    assert names >= {s for pair in NESTING for s in pair}
    for name, outer in NESTING:
        assert inside(spans, name, outer), (name, outer)
    count = {n: sum(1 for _, _, m in spans if m == n) for n in names}
    assert count["render.frame"] == 1 and count["render.bounce"] == 4
    assert count["sync.compaction_count"] == 4
    assert sum(v for n, v in count.items() if n.startswith("sync.")) \
        == d["host_syncs"] == 6
    # the image copy is the renderer's, after the frame
    assert not inside(spans, "sync.image_copy", "render.frame")


def test_batch_spans(chunk):
    _, d, spans = recorded(lambda: batch(chunk))
    names = [n for _, _, n in spans]
    assert names.count("renderer.batch") == 1
    assert names.count("render.frame") == 4
    assert inside(spans, "render.frame", "renderer.batch")
    assert sum(n.startswith("sync.") for n in names) == d["host_syncs"] == 17


def test_general_path_names_every_sync():
    """The general shade on `headline.general_setup`'s scene (a sparse
    light set: the BVH walks and the sparse NEE sweep; the ego cube: the
    triangle sweep) under the NaN checks: each of its syncs is one
    span."""
    scene, settings, basis, prefs = general_setup(16, 16, 2, device="cpu")
    renderer = rr.Renderer(settings.replace(trace_audit=True), device="cpu")
    with validation_layer():
        (_, aux), d, spans = recorded(lambda: renderer.render(
            scene, basis, prefs, 7, with_aux=True))
    assert aux["nee_overflow"] == 0
    syncs = [n for _, _, n in spans if n.startswith("sync.")]
    assert set(syncs) == {
        "sync.compaction_count", "sync.audit", "sync.image_copy",
        "sync.light_walk", "sync.reverse_walk", "sync.nee_sweep",
        "sync.nee_slots", "sync.seed", "sync.tri_pool", "sync.nan_check"}
    assert len(syncs) == d["host_syncs"]
    assert "render.shade" in {n for _, _, n in spans}


def test_off_path_makes_no_record_function(chunk, monkeypatch):
    """With no session recording, no span is made: the helper hands out
    one shared no-op context."""
    def refuse(*a, **kw):
        raise AssertionError("record_function made with no session")

    monkeypatch.setattr(spans_mod, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert span("a") is span("b", 3) is host_sync("sync.x")
    single(chunk)
    batch(chunk)
    with StageTimer().stage("gen"):
        pass


def test_stage_timer_opens_a_span():
    st = StageTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with st.stage("worldgen"):
            torch.ones(4).sum()
    assert any(e.name() == "worldgen"
               for e in prof.profiler.kineto_results.events())
    assert st.counts["worldgen"] == 1


def test_images_equal_with_and_without_a_session(chunk):
    for fn in (single, batch):
        off = fn(chunk)
        on, _, spans = recorded(lambda: fn(chunk))
        assert spans
        np.testing.assert_array_equal(on, off)


@pytest.mark.parametrize("case", ["sort_bounce_1", "no_compaction"])
def test_lanes_only_where_the_host_counts_the_alive_rays(chunk, monkeypatch,
                                                         case):
    """A bounce whose alive rays the host does not count (a compaction
    after a skipped sort sizes its bucket by the last alive slot; no
    compaction sizes none) adds neither slots nor alive rays; bounce 0's
    rays are all alive either way."""
    settings = FRAME.replace(sort_bounces=(1,)) if case == "sort_bounce_1" \
        else FRAME.replace(compaction=False)
    sorted_buckets = []
    real = rr.compaction_bucket

    def spy(alive, sorted_now):
        m, count = real(alive, sorted_now)
        if sorted_now:
            sorted_buckets.append((count, m))
        return m, count

    monkeypatch.setattr(rr, "compaction_bucket", spy)
    _, d = delta(lambda: single(chunk, settings))
    n = FRAME.render_width * FRAME.render_height
    # 4 compaction counts (none without compaction), the audit, the copy
    assert d["host_syncs"] == (6 if case == "sort_bounce_1" else 2)
    assert len(sorted_buckets) == (1 if case == "sort_bounce_1" else 0)
    assert d["ray_slots"] == n + sum(m for _, m in sorted_buckets)
    assert d["rays_alive"] == n + sum(a for a, _ in sorted_buckets)


class _Event:
    def __init__(self, name, device, annotation=None):
        self.name, self.device_time = name, 1.0
        self.device_type = getattr(torch.autograd.DeviceType, device)
        if annotation is not None:
            self.is_user_annotation = annotation


class _Prof:
    def __init__(self, events):
        self._events = events

    def events(self):
        return self._events


def test_device_events_leave_out_the_spans_copies():
    """A span's device-side copy is no device work: typed as a user
    annotation, or (where the profiler gives no such flag) named as one
    of the program's spans."""
    prof = _Prof([
        _Event("trace_kernel", "CUDA", False),
        _Event("Memcpy DtoH", "CUDA"),
        _Event("bench.frame", "CUDA", True),
        _Event("render.frame", "CUDA"),
        _Event("sync.image_copy", "CUDA", False),
        _Event("aten::sort", "CPU", False),
    ])
    assert [e.name for e in device_events(prof)] == ["trace_kernel",
                                                     "Memcpy DtoH"]


PORT = Path(__file__).resolve().parents[1] / "wavefront_tpu_torch"
READERS = sorted(PORT.rglob("*.py"))
# the calls that pass a span name on rather than name one
FORWARDS = {("utils/spans.py", "host_sync"), ("utils/profiling.py", "stage")}


def _calls(path):
    """(enclosing function, called name, first argument) of every call in
    `path`."""
    tree = ast.parse(path.read_text())
    out = []

    def visit(node, fn):
        for child in ast.iter_child_nodes(node):
            inner = child.name if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else fn
            if isinstance(child, ast.Call):
                f = child.func
                name = f.id if isinstance(f, ast.Name) else getattr(
                    f, "attr", None)
                out.append((fn, name, child.args[0] if child.args else None))
            visit(child, inner)

    visit(tree, None)
    return out


def test_every_span_name_is_registered():
    """Every span the port opens (`span`, `host_sync`) names itself with
    a literal of `SPAN_NAMES`, and every registered name is opened
    somewhere: a profiler that tells spans by name (the benchmark's
    under torch 2.11) would otherwise take an unregistered span's
    device-side copy for device work.  Only the helpers that hand a name
    on take one that is not a literal."""
    opened, forwards = set(), set()
    for path in sorted(PORT.rglob("*.py")):
        rel = str(path.relative_to(PORT))
        for fn, name, arg in _calls(path):
            if name not in ("span", "host_sync"):
                continue
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                opened.add(arg.value)
            else:
                forwards.add((rel, fn))
    assert opened == set(SPAN_NAMES)
    assert len(SPAN_NAMES) == len(set(SPAN_NAMES))
    assert forwards == FORWARDS


def test_readers_of_device_events_leave_out_spans():
    """Every reader of a profiler's events in the port takes its device
    events through `device_events`: none filters `prof.events()` by device
    type itself."""
    for path in READERS:
        if path.name == "spans.py":
            continue
        text = path.read_text()
        assert "DeviceType.CUDA" not in text, path
        assert "prof.events()" not in text, path

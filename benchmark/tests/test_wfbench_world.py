"""The check of `world.orbit` (the game's step, `GameWorld.step`, with the
ego cube) fails the control and each fault, and passes the sound
program; and the cell's new readers (`world.managers_ms`,
`entities.ms_per_frame`, `tri_sweep_roofline`) read the program's spans
and S5's launches, and stay silent without them.  On the CPU at 32x18
(the kernels' plain versions), on the whole 416x96x416 window; the
reference's scene is built once for the file."""

import functools
import os
import types

import pytest
import torch

from benchmark.harness import check, program, spec
from benchmark.harness.spec import reader
from benchmark.harness.tracing import Spans, Trace
from benchmark.tests._runs import cpu_run
from benchmark.tests.test_wfbench_faults import (altered, half_left_out,
                                                 stale, truncated)
from benchmark.tests.test_wfbench_trace import LAUNCHED, Event, session

CELL = "world.orbit"
# a step takes ~0.3 s at 32x18 on the CPU; a stale image shows from the
# second image on
SECONDS = {"stale": 3.0}


@pytest.fixture(scope="module")
def scene():
    cell = spec.load_cell(CELL)
    return cell.build.reference(cell.config,
                                os.path.join(spec.ROOT, "assets"), "cpu")


@pytest.fixture
def run(scene, monkeypatch):
    monkeypatch.setattr(check, "compare",
                        functools.partial(check.compare, scene=scene))
    return functools.partial(cpu_run, CELL)


def test_sound_program_passes(run):
    res = run()
    assert res["correct"], res["check"]
    assert all(c["value"] < c["limit"] / 5 for c in res["check"].values())


@pytest.mark.parametrize("fault", [stale, half_left_out, altered, truncated])
def test_fault_fails(run, fault):
    res = run(seconds=SECONDS.get(fault.__name__, 1.0), fault=fault)
    if fault is stale:
        assert res["attempted"] >= 2
    assert not res["correct"], (fault.__name__, res["check"])


def test_control_fails(run):
    """The control: the program's bfloat16 color pipeline, the precision
    below the configuration's float32."""
    res = run(settings={"shade_bf16": True})
    assert not res["correct"]
    assert res["check"]["off_share"]["value"] > 0.5


def world_session(s5_records=4):
    """session()'s two frames in a 1-ms window, with each frame's
    `world.managers` span (100 us and 300 us), a `render.entities` span
    in each holding two launch calls of S5 (10-us kernels), the second
    frame's record lost unless `s5_records` is 4."""
    ses = session(4, 4)
    ev = list(ses.profiler.kineto_results.events())
    ev += [Event("user_annotation", "world.managers", 20_000, 100_000),
           Event("user_annotation", "world.managers", 520_000, 300_000)]
    corr = 1000
    for i, start in enumerate((150_000, 850_000)):
        ev.append(Event("user_annotation", "render.entities", start,
                        40_000))
        for j in range(2):
            t = start + 5_000 + 15_000 * j
            ev.append(Event("cuda_runtime", "cudaLaunchKernel", t, 1_000,
                            corr))
            if 2 * i + j < s5_records:
                ev.append(Event("kernel", "void tri_sweep_kernel(Rays)",
                                t + 2_000, 10_000, corr))
            corr += 1
    ses.profiler.kineto_results.events = lambda: ev
    return ses


def test_world_readers_read_the_program():
    names = ("world.managers", "render.entities")
    launched = {**LAUNCHED, "tri_sweep_kernel": 4}
    mask = torch.zeros(64, dtype=torch.bool)
    mask[:12] = True
    records = {"tri_sweep": [(2_073_600, mask, True)] * 4}
    tr = Trace(world_session(), 2, records, names, launched)
    assert reader("metrics", "world.managers_ms").read(tr) \
        == pytest.approx(0.2)
    assert reader("metrics", "entities.ms_per_frame").read(tr) \
        == pytest.approx(0.02)
    mod = reader("metrics", "tri_sweep_roofline")
    bound_ms = 4e3 * mod.s5_bound_s(2_073_600, 64, 12, True)
    assert reader("metrics", "tri_sweep_roofline").read(tr) \
        == pytest.approx(100.0 * bound_ms / 0.04)
    # at 12 triangles operations bound the sweep, bytes its stream form
    by_ops, by_bytes = (
        [mod.s5_ops(2_073_600, 12, f) / mod.OPS_PER_S for f in (0, 1)],
        [mod.s5_bytes(2_073_600, 64, f) / 3.35e12 for f in (0, 1)])
    assert by_ops[0] > by_bytes[0] and by_ops[1] < by_bytes[1]


def test_world_readers_silent_without_the_program():
    """A trace without the spans, a lost S5 record, or S5 launches the
    wrapper did not see, leave the readers out."""
    launched = {**LAUNCHED, "tri_sweep_kernel": 4}
    bare = Trace(session(4, 4), 2, {}, (), LAUNCHED)
    for name in ("world.managers_ms", "entities.ms_per_frame",
                 "tri_sweep_roofline"):
        assert reader("metrics", name).read(bare) is None
    mask = torch.ones(64, dtype=torch.bool)
    names = ("world.managers", "render.entities")
    lost = Trace(world_session(3), 2,
                 {"tri_sweep": [(100, mask, True)] * 4},
                 names, launched)
    assert lost.lost and reader("metrics", "tri_sweep_roofline").read(
        lost) is None
    assert reader("metrics", "entities.ms_per_frame").read(lost) is None
    short = Trace(world_session(), 2,
                  {"tri_sweep": [(100, mask, True)] * 3},
                  names, launched)
    assert reader("metrics", "tri_sweep_roofline").read(short) is None


def test_s5_wrappers_count_each_launch(monkeypatch):
    """The wrappers take the sweep (`tri_sweep` as `render/intersect.py`
    calls it) and its stream form (`entity_stream` as
    `render/renderer.py` calls it), record each non-empty call's rays,
    pool mask and form, and call the real kernel; a program without the
    kernel installs nothing."""
    import wavefront_tpu_torch.render.intersect as ix
    import wavefront_tpu_torch.render.renderer as rr

    calls = []
    monkeypatch.setattr(ix, "tri_sweep",
                        lambda v, a, o, d, *r: calls.append(o.x.shape[0]))
    monkeypatch.setattr(rr, "entity_stream",
                        lambda v, a, uv, tx, nt, o, *r: calls.append(-1))
    spans = Spans()
    mod = reader("metrics", "tri_sweep_roofline")
    assert mod.install(spans, None)
    mask = torch.ones(3, dtype=torch.bool)
    for n in (100, 0, 7):
        o = types.SimpleNamespace(x=torch.zeros(n))
        ix.tri_sweep(None, mask, o, None, 0.001, 1000.0, None)
        rr.entity_stream(None, mask, None, None, 1, o, None, None, None,
                         0.001, 1000.0, None)
    assert calls == [100, -1, 0, -1, 7, -1]
    assert [(n, m is mask, f) for n, m, f in spans.records["tri_sweep"]] \
        == [(100, True, False), (100, True, True), (7, True, False),
            (7, True, True)]
    monkeypatch.delattr(ix, "tri_sweep")
    monkeypatch.delattr(rr, "entity_stream")
    assert not mod.install(Spans(), None)
    assert program.install_spans(Spans())

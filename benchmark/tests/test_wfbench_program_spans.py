"""The readers of the program's own spans and counters, on hand-made
traces: each gives its value where the program's spans and counters are
in the trace, and stays silent on a trace without them (an older
program's) and, where it reads device records, on one that lost a K1
record."""

import pytest

from benchmark.harness import program
from benchmark.harness.spec import reader
from benchmark.harness.tracing import FRAME_SPAN, WINDOW_SPAN, Trace
from benchmark.tests.test_wfbench_trace import LAUNCHED, Event, session

NEW = ("frame_loop.host_syncs", "frame_loop.sync_wait_ms",
       "frame_loop.host_bound_ms", "frame_loop.lane_use_pct",
       "frame_loop.sort_key_ms", "frame_loop.compact_ms",
       "entry.image_copy_ms")
RECORDS_BASED = ("frame_loop.host_bound_ms", "frame_loop.sort_key_ms",
                 "frame_loop.compact_ms", "entry.image_copy_ms")


def program_session(k1_records=4):
    """session()'s two frames in a 1-ms window (K1 and K2 launched every
    100 us from 10 us on, each kernel 20 us long, 5 us after its launch
    call), with the program's spans: each frame's `renderer.render`
    from 20 us into the frame to its end; a `render.sort_key` span
    holding the first K2 launch call (at 410 us), a `render.compact`
    span holding the third (610 us) with a `sync.compaction_count`
    inside it, and a `sync.image_copy` span holding a copy's launch
    call (at 900 us) and its 40-us copy."""
    ses = session(k1_records, 4)
    ev = list(ses.profiler.kineto_results.events())
    ev += [
        Event("user_annotation", "renderer.render", 20_000, 480_000),
        Event("user_annotation", "renderer.render", 520_000, 480_000),
        Event("user_annotation", "render.sort_key", 400_000, 20_000),
        Event("user_annotation", "render.compact", 600_000, 30_000),
        Event("user_annotation", "sync.compaction_count", 605_000, 10_000),
        Event("user_annotation", "sync.image_copy", 890_000, 60_000),
        Event("cuda_runtime", "cudaMemcpyAsync", 900_000, 1_000, 99),
        Event("gpu_memcpy", "Memcpy DtoH", 905_000, 40_000, 99),
    ]
    ses.profiler.kineto_results.events = lambda: ev
    return ses


# the counters' deltas of the window's two images (one frame each)
COUNTS = {program.KEY: [
    {"host_syncs": 6, "ray_slots": 80, "rays_alive": 60},
    {"host_syncs": 6, "ray_slots": 80, "rays_alive": 60}]}


def read(name, tr):
    return reader("metrics", name).read(tr)


def test_readers_read_the_program():
    tr = Trace(program_session(), 2, dict(COUNTS), (), LAUNCHED)
    assert tr.whole()
    assert read("frame_loop.host_syncs", tr) == 6.0
    assert read("frame_loop.lane_use_pct", tr) == pytest.approx(75.0)
    # sync spans: 60 us + 10 us of host time, over 2 frames
    assert read("frame_loop.sync_wait_ms", tr) == pytest.approx(0.035)
    # the K2 kernel launched at 410 us (20 us), over 2 frames
    assert read("frame_loop.sort_key_ms", tr) == pytest.approx(0.010)
    assert read("frame_loop.compact_ms", tr) == pytest.approx(0.010)
    # the copy launched inside sync.image_copy (40 us)
    assert read("entry.image_copy_ms", tr) == pytest.approx(0.020)


def test_host_bound_counts_idle_inside_program_spans_only():
    """Idle time inside `renderer.render` counts; the idle time in
    `bench.frame` before it (0-20 us and 500-520 us) does not."""
    tr = Trace(program_session(), 2, dict(COUNTS), (), LAUNCHED)
    busy = [(a, b) for a, b in tr.busy]
    inside = [(20_000, 500_000), (520_000, 1_000_000)]
    idle_in = sum(b - a for a, b in inside) - program.overlap_ns(busy, inside)
    assert read("frame_loop.host_bound_ms", tr) == \
        pytest.approx(idle_in * 1e-6 / 2)
    # the harness's frame spans alone: nothing of the program to read
    bare = Trace(session(4, 4), 2, {}, (), LAUNCHED)
    assert bare.spans[FRAME_SPAN] and bare.spans[WINDOW_SPAN]
    assert read("frame_loop.host_bound_ms", bare) is None


@pytest.mark.parametrize("name", NEW)
def test_silent_without_the_program(name):
    """A parent's trace: the harness's spans, no program span, no
    counters."""
    tr = Trace(session(4, 4), 2, {}, (), LAUNCHED)
    assert tr.whole()
    assert read(name, tr) is None


@pytest.mark.parametrize("name", NEW)
def test_lost_k1_record_silences_the_records_readers(name):
    tr = Trace(program_session(k1_records=3), 2, dict(COUNTS), (), LAUNCHED)
    assert not tr.whole()
    got = read(name, tr)
    assert (got is None) == (name in RECORDS_BASED)


class System:
    def __init__(self):
        self.calls = 0

    def frame(self, yaw, frame_count, k=1):
        from wavefront_tpu_torch.utils.spans import host_sync

        self.calls += 1
        for _ in range(2 * k):
            with host_sync("sync.audit"):
                pass
        return None, {}


def test_counters_recorded_a_call():
    """`install_counters` wraps the system's frame once (both readers
    install it) and records each call's deltas."""
    from benchmark.harness.tracing import Spans

    spans, system = Spans(), System()
    assert program.install_counters(spans, system)
    assert program.install_counters(spans, system)
    system.frame(0.1, 7, 4)
    system.frame(0.2, 11)
    recs = spans.records[program.KEY]
    assert system.calls == 2
    assert [r["host_syncs"] for r in recs] == [8, 2]
    assert {"ray_slots", "rays_alive", "launches.trace_kernel"} <= set(recs[0])


def test_counters_absent_install_nothing(monkeypatch):
    from benchmark.harness.tracing import Spans

    monkeypatch.setattr(program, "MODULE", "no_such_module_here")
    system = System()
    frame = system.frame
    assert not program.install_counters(Spans(), system)
    assert system.frame == frame


class Untyped:
    """An event as torch 2.11's profiler gives it: no activity type, so
    the trace tells kinds apart by device and name."""

    def __init__(self, e, on_device=None):
        self._e = e
        self._dev = on_device

    def device_type(self):
        if self._dev is not None:
            return "cuda" if self._dev else "cpu"
        return self._e.device_type()

    def __getattr__(self, attr):
        if attr == "activity_type":
            raise AttributeError(attr)
        return getattr(self._e, attr)


def untyped_session():
    """program_session()'s events without activity types, and a
    device-side copy of each program span (as the profiler records a
    span that launched device work)."""
    ses = program_session()
    ev = list(ses.profiler.kineto_results.events())
    out = [Untyped(e) for e in ev]
    out += [Untyped(e, on_device=True) for e in ev
            if e.name().startswith(program.PREFIXES)]
    ses.profiler.kineto_results.events = lambda: out
    return ses


def test_untyped_events_need_the_program_names():
    """Without the program's names its spans read as host ops and their
    device-side copies as device operations; `install_spans` adds the
    names, and the readers read what typed events give."""
    from benchmark.harness.tracing import Spans

    typed = Trace(program_session(), 2, dict(COUNTS), (), LAUNCHED)
    bare = Trace(untyped_session(), 2, dict(COUNTS), (), LAUNCHED)
    assert len(bare.ops) > len(typed.ops)
    assert read("frame_loop.sync_wait_ms", bare) is None
    spans = Spans()
    assert program.install_spans(spans)
    named = Trace(untyped_session(), 2, dict(COUNTS), spans.installed,
                  LAUNCHED)
    assert len(named.ops) == len(typed.ops)
    for name in NEW:
        assert read(name, named) == pytest.approx(read(name, typed)), name

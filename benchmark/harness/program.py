"""What the per-layer metrics read of the program's own spans and
counters.

The program names its frame's stages in spans of its own
(`wavefront_tpu_torch/utils/spans.py::span`, re-exported by
`utils/profiling.py`): `renderer.*` around
`Renderer`'s calls, `render.*` around `render_frame`'s stages, and
`sync.*` around each point where the host waits for the card.  They are
`record_function` spans of the harness's profiler session, on the
device records' clock.  Where the profiler's events carry no activity
type (torch 2.11's), `Trace` tells a span from a host op, and a span's
device-side copy from a device operation, by name alone:
`install_spans` adds the program's names (`profiling.SPAN_NAMES`) to the
harness's.  The accepted metrics that count device operations or busy
time (`frame_loop.device_ops`, `device.idle_pct`, `frame_loop.sort_ms`,
`k1_trace.ms_per_frame`) read the same as without the program's spans
only where one of these installs ran: in a cell that lists a metric of
this module.  Its counters (`profiling.counters()`) are always on;
`install_counters` wraps the system's `frame` so that each image's
deltas land in the trace's `records`.  A program without them (an older
one) leaves every metric that reads them out.
"""

from __future__ import annotations

import importlib

from benchmark.harness.tracing import _merge

MODULE = "wavefront_tpu_torch.utils.profiling"
# the names of the program's spans begin with one of these
PREFIXES = ("renderer.", "render.", "sync.")
SYNC = "sync."
KEY = "program_counters"


def _program(attr: str):
    try:
        return getattr(importlib.import_module(MODULE), attr)
    except (ImportError, AttributeError):
        return None


def install_spans(spans) -> bool:
    """Adds the program's span names to the harness's span names
    (`spans.installed`, which `Trace` is given); False where the program
    names none."""
    names = _program("SPAN_NAMES")
    if not names:
        return False
    spans.installed.update(names)
    return True


def install_counters(spans, system) -> bool:
    """Wraps `system.frame` so that each call appends the program's
    counter deltas over it to `spans.records[KEY]`, and adds the
    program's span names; False where the program keeps no counters."""
    counters = _program("counters")
    if counters is None or not install_spans(spans):
        return False
    frame = getattr(system, "frame", None)
    if frame is None or not callable(frame):
        return False
    if getattr(frame, "_bench_counters", False):
        return True
    records = spans.records[KEY]

    def wrapped(*a, **kw):
        before = counters()
        try:
            return frame(*a, **kw)
        finally:
            after = counters()
            records.append({k: after[k] - before.get(k, 0) for k in after})

    wrapped._bench_counters = True
    system.frame = wrapped
    return True


def counted(trace, name: str):
    """The counter `name`'s total over the window's images, or None
    where the trace holds no counts of it."""
    recs = trace.records.get(KEY)
    if not recs or any(name not in r for r in recs):
        return None
    return sum(r[name] for r in recs)


def spans(trace, prefix=PREFIXES) -> list:
    """The merged intervals of the program's spans whose names begin with
    `prefix`, inside the window."""
    iv = [(max(a, trace.t0), min(b, trace.t1))
          for name, v in trace.spans.items() if name.startswith(prefix)
          for a, b in v if b > trace.t0 and a < trace.t1]
    return _merge(iv)


def idle(trace) -> list:
    """The window's intervals in which the card runs no operation."""
    out, prev = [], trace.t0
    for a, b in trace.busy + [[trace.t1, trace.t1]]:
        if a > prev:
            out.append((prev, a))
        prev = max(prev, b)
    return out


def overlap_ns(xs: list, ys: list) -> int:
    """Total length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = total = 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if hi > lo:
            total += hi - lo
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def device_ms_per_frame(trace, *names):
    """Device ms a frame of the ops launched inside the spans `names`;
    None where the trace lost kernel records or nothing was launched
    inside them."""
    if not trace.whole():
        return None
    got = [ms for ms in map(trace.device_ms_under, names) if ms is not None]
    return per_frame(trace, sum(got))


def per_frame(trace, value):
    """value over the window's frames, or None where there is nothing
    (no value, a zero, no frame)."""
    if not value or not trace.frames:
        return None
    return value / trace.frames

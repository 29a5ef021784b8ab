"""Spans from the harness's own files, and the reading of one trace.

In a traced run the per-layer metrics' modules wrap calls into the
program's layers (module globals, or methods of the system's objects)
in `torch.profiler.record_function` spans before set-up ends; the
window then runs inside one profiler `Session`, and `Trace` digests that
session's events once: the device operations (kernels, copies, fills)
with their host launch calls, the spans on the host, and the host ops.
A wrapper that finds nothing to wrap leaves its metric silent.

torch.profiler can lose kernel records (their launch calls stay in the
trace).  The session opens with empty warm-up launches, which take such
a loss in place of the window's kernels, and holds the kernel records
inside the window against the program's own launch counters of K1-K3:
`Trace.lost` names each shortfall, and the metrics that read records
are left out of a trace that has one.
"""

from __future__ import annotations

import bisect
import importlib
from collections import defaultdict

WINDOW_SPAN = "bench.window"
FRAME_SPAN = "bench.frame"
WARMUP_SPAN = "bench.warmup"
# empty kernels launched ahead of the window's span in its session
WARMUP_LAUNCHES = 64
# the program's map of kernel record names to the wrappers whose
# `launches` count their launches
COUNTERS = ("wavefront_tpu_torch.utils.profiling", "FRAME_KERNELS")
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_KINDS = ("cuda_runtime", "cuda_driver")


class Spans:
    """Wraps callables in named spans; `records` is a scratch dict the
    metrics' wrappers may fill (launch sizes), reset at the window's
    start."""

    def __init__(self):
        self.records = defaultdict(list)
        self.installed = set()

    def wrap(self, owner, attr: str, span: str) -> bool:
        from torch.profiler import record_function

        fn = getattr(owner, attr, None)
        if fn is None or not callable(fn):
            return False
        if getattr(fn, "_bench_span", None) == span:
            return True

        def wrapped(*a, **kw):
            with record_function(span):
                return fn(*a, **kw)

        wrapped._bench_span = span
        setattr(owner, attr, wrapped)
        self.installed.add(span)
        return True

    def wrap_global(self, module: str, attr: str, span: str) -> bool:
        try:
            mod = importlib.import_module(module)
        except ImportError:
            return False
        return self.wrap(mod, attr, span)


def launch_counts():
    """{kernel record name: launches so far} from the program's
    counters, or None where the program has none under that name."""
    try:
        kernels = getattr(importlib.import_module(COUNTERS[0]), COUNTERS[1])
        return {name: int(fn.launches) for name, fn in kernels.items()}
    except (ImportError, AttributeError, TypeError, ValueError):
        return None


class Session:
    """One torch.profiler session around the measured window.  `open`
    starts it on an idle card, runs the warm-up launches in their own
    span, reads the launch counters and enters the window's span;
    `close` waits for the card, leaves the span, stops the session and
    keeps the launches counted in between (`launched`, or None)."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.cuda = torch.cuda.is_available()
        self.prof = profile(activities=[ProfilerActivity.CPU]
                            + ([ProfilerActivity.CUDA] if self.cuda else []))
        self.launched = None

    def _sync(self):
        import torch

        if self.cuda:
            torch.cuda.synchronize()

    def open(self):
        import torch
        from torch.profiler import record_function

        self._sync()
        self.prof.start()
        if self.cuda:
            with record_function(WARMUP_SPAN):
                pad = torch.zeros(1, device="cuda")
                for _ in range(WARMUP_LAUNCHES):
                    pad.add_(1.0)
            self._sync()
        self._before = launch_counts()
        self._span = record_function(WINDOW_SPAN)
        self._span.__enter__()

    def close(self):
        self._sync()
        self._span.__exit__(None, None, None)
        self.prof.stop()
        after = launch_counts()
        if self._before is not None and after is not None:
            self.launched = {k: after[k] - self._before.get(k, 0)
                             for k in after}


def _kind(e, span_names) -> str:
    """device (kernel, copy, fill), runtime (a launch call), span (the
    harness's, on the host), op (a host op), or other (a span's
    device-side copy)."""
    kind = getattr(e, "activity_type", None)
    on_device = "cpu" not in str(e.device_type()).lower()
    name = e.name()
    if kind is not None:
        kind = str(kind())
        if kind in DEVICE_KINDS:
            return "device"
        if kind in RUNTIME_KINDS:
            return "runtime"
        if kind == "user_annotation":
            return "span"
        return "op" if kind == "cpu_op" else "other"
    if on_device:
        return "other" if name in span_names else "device"
    if name in span_names:
        return "span"
    if name.startswith(("cuda", "cu")) and not name.startswith("cudnn"):
        return "runtime"
    return "op"


def _times(e):
    if hasattr(e, "start_ns"):
        return e.start_ns(), e.duration_ns()
    return int(e.start_us() * 1000), int(e.duration_us() * 1000)


def _merge(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """One profiler session's events, in ns on the trace's clock.

    `span_names`: the names of the harness's spans, which tell the host
    spans (and their device-side copies) from the host ops."""

    def __init__(self, prof, frames: int, records=None, span_names=(),
                 launched=None):
        self.frames = frames
        self.launched = launched
        self.records = records or {}
        names = set(span_names) | {WINDOW_SPAN, FRAME_SPAN}
        device, runtime = [], {}
        spans = defaultdict(list)
        self.cpu_ops = []
        self.kinds = defaultdict(int)
        for e in prof.profiler.kineto_results.events():
            kind = _kind(e, names)
            self.kinds[kind] += 1
            if kind == "other":
                continue
            start, dur = _times(e)
            end = start + dur
            if kind == "device":
                device.append((start, end, e.name(), e.correlation_id(),
                               e.linked_correlation_id()))
            elif kind == "runtime":
                runtime[e.correlation_id()] = start
            elif kind == "span":
                spans[e.name()].append((start, end))
            else:
                self.cpu_ops.append((start, end, e.name()))
        if not spans.get(WINDOW_SPAN):
            raise RuntimeError("trace: the window's span is missing")
        self.t0, self.t1 = spans[WINDOW_SPAN][0]
        self.spans = {k: _merge(v) for k, v in spans.items()}
        self.span_list = sorted((a, b, k) for k, v in spans.items()
                                for a, b in v if k != WINDOW_SPAN)
        # device ops inside the window, each with its launch time
        self.ops = []
        for start, end, name, corr, linked in device:
            if end <= self.t0 or start >= self.t1:
                continue
            launch = runtime.get(corr, runtime.get(linked))
            self.ops.append((max(start, self.t0), min(end, self.t1), name,
                             launch))
        self.ops.sort()
        self.cpu_ops.sort()
        self.busy = _merge([(a, b) for a, b, _, _ in self.ops])
        self.kinds["device_ops_launch_found"] = sum(
            1 for op in self.ops if op[3] is not None)
        # counted launches of K1-K3 whose records the window lacks
        self.lost = {}
        for name, n in (launched or {}).items():
            got = sum(1 for op in self.ops if name in op[2])
            if got < n:
                self.lost[name] = {"launched": n, "recorded": got}

    def whole(self, *names) -> bool:
        """Whether the launches were counted and the window holds a
        record of each counted launch (of the kernels `names`, or of
        every counted kernel when none is named)."""
        if self.launched is None:
            return False
        return not any(n in self.lost for n in (names or self.lost))

    def launches(self, name: str) -> int:
        return (self.launched or {}).get(name, 0)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) * 1e-9

    def device_ms(self, match) -> float:
        """Device ms of the ops whose name contains `match`."""
        return sum(b - a for a, b, n, _ in self.ops if match in n) * 1e-6

    def host_ms(self, span: str) -> float:
        """Host ms inside the span."""
        return sum(b - a for a, b in self.spans.get(span, [])) * 1e-6

    def device_ms_under(self, span: str):
        """Device ms of the ops launched inside the span, or None when
        nothing was launched inside it in the window."""
        iv = self.spans.get(span)
        if not iv:
            return None
        starts = [a for a, _ in iv]
        total = 0
        for a, b, _, launch in self.ops:
            if launch is None:
                continue
            i = bisect.bisect_right(starts, launch) - 1
            if i >= 0 and launch <= iv[i][1]:
                total += b - a
        return total * 1e-6 if total else None

    def _innermost(self, items, t):
        """Name of the innermost (latest started) of sorted (start, end,
        name) items that holds t."""
        i = bisect.bisect_right(items, (t, float("inf"), "")) - 1
        for j in range(i, max(-1, i - 20000), -1):
            a, b, name = items[j]
            if a <= t <= b:
                return name
        return None

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took the most time, and the longest idle
        gaps, each named by the harness span and the host op the host
        was in at its middle."""
        by_name = defaultdict(int)
        for a, b, n, _ in self.ops:
            by_name[n] += b - a
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps, prev = [], self.t0
        for a, b in self.busy + [[self.t1, self.t1]]:
            if a > prev:
                gaps.append((a - prev, prev, a))
            prev = max(prev, b)
        gaps.sort(reverse=True)
        named = []
        for length, a, b in gaps[:top]:
            mid = (a + b) // 2
            span = self._innermost(self.span_list, mid) or "harness"
            op = self._innermost(self.cpu_ops, mid)
            named.append([span + ("/" + op if op else ""), length * 1e-9])
        return {"device_ops": [[n[:64], v * 1e-9] for n, v in ops],
                "idle_gaps": named}

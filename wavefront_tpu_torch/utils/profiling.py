"""Tracing / profiling / metrics.

The reference's only observability is a once-per-second fps print
(reference main.rs:872-879) and dbg! traces on slow paths (SURVEY.md
section 5).  Here: a frame timer with fps + Mrays/sec counters, optional
per-stage wall timing, and a `torch.profiler` trace context for a device
timeline.  The counterpart of `wavefront_tpu.utils.profiling`.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, Optional

import torch

# the default trace directory, beside the port's build directory
TRACE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "wavefront_tpu_torch", "trace")


@dataclass
class FrameStats:
    frame_ms: float
    fps: float
    mrays_per_sec: float


class FrameTimer:
    """Rolling frame timing + throughput metrics."""

    def __init__(self, rays_per_frame: int, window: int = 60):
        self.rays_per_frame = rays_per_frame
        self._times = deque(maxlen=window)
        self._last_report = time.perf_counter()
        self._frames_since_report = 0

    @contextlib.contextmanager
    def frame(self):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self._times.append(dt)
        self._frames_since_report += 1

    @property
    def stats(self) -> Optional[FrameStats]:
        if not self._times:
            return None
        mean = sum(self._times) / len(self._times)
        return FrameStats(
            frame_ms=mean * 1000.0,
            fps=1.0 / mean if mean > 0 else float("inf"),
            mrays_per_sec=self.rays_per_frame / mean / 1e6 if mean > 0 else 0.0,
        )

    def maybe_report(self, interval: float = 1.0) -> Optional[FrameStats]:
        """Once-per-`interval` stats, the reference's fps-print cadence
        (main.rs:872-879)."""
        now = time.perf_counter()
        if now - self._last_report >= interval and self._times:
            self._last_report = now
            self._frames_since_report = 0
            return self.stats
        return None


class StageTimer:
    """Named wall-clock stage accumulator for host-side phases (worldgen,
    light-BVH build, upload)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, float]:
        return {
            k: self.totals[k] / max(self.counts[k], 1) for k in self.totals
        }


# empty kernel launches at the start of every device trace: each profiler
# session of tens of thousands of device events whose events were read
# (`events()`, `key_averages()`) makes torch.profiler drop one more of the
# first kernel records of every later session in the process (their
# launch calls stay in the trace); these launches take that loss in place
# of the traced region's kernels
WARMUP_LAUNCHES = 64
WARMUP_SPAN = "device_trace.warmup"


@contextlib.contextmanager
def device_trace(log_dir: str = TRACE_DIR):
    """Capture a `torch.profiler` timeline (host ops, and the card's
    kernels when CUDA is available) around a code region; on exit it is
    written to `log_dir/trace.json` as a Chrome trace (chrome://tracing,
    Perfetto).  On a card the window opens with `WARMUP_LAUNCHES` empty
    kernels in a span named `WARMUP_SPAN`.  Yields `log_dir`."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=acts)
    if cuda:
        # the window opens on an idle card: no kernel of earlier work
        # straddles its start
        torch.cuda.synchronize()
    prof.start()
    if cuda:
        with record_function(WARMUP_SPAN):
            pad = torch.zeros(1, device="cuda")
            for _ in range(WARMUP_LAUNCHES):
                pad.add_(1.0)
            torch.cuda.synchronize()
    try:
        yield log_dir
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))

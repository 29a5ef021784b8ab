"""Tracing / profiling / metrics.

The reference's only observability is a once-per-second fps print
(reference main.rs:872-879) and dbg! traces on slow paths (SURVEY.md
section 5).  Here: a frame timer with fps + Mrays/sec counters, optional
per-stage wall timing, and a `torch.profiler` trace context for a device
timeline.  The counterpart of `wavefront_tpu.utils.profiling`.

The frame path's spans and counters are in `utils/spans.py` (`span`,
`host_sync`, re-exported here); `counters()` snapshots them with the
frame kernels' launches (K1-K3, the bounce sort's key and permute, the
sparse NEE sweep, the light walk and the entity triangle sweep).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
import warnings
from collections import deque
from dataclasses import dataclass
from typing import Dict, Optional

import torch

from wavefront_tpu_torch.kernels.light_walk import light_walk
from wavefront_tpu_torch.kernels.nee_sweep import nee_sweep
from wavefront_tpu_torch.kernels.ray_sort import ray_key, ray_permute
from wavefront_tpu_torch.kernels.shade import shade_pass
from wavefront_tpu_torch.kernels.texel import texel_fetch
from wavefront_tpu_torch.kernels.tri_sweep import tri_sweep
from wavefront_tpu_torch.kernels.window_trace import window_trace
from wavefront_tpu_torch.utils import spans
from wavefront_tpu_torch.utils.spans import (  # noqa: F401  re-exported
    SPAN_NAMES, device_events, host_sync, span)

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
    light-BVH build, upload); each stage is also a `span` of its name."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        with span(name):
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
# of the traced region's kernels, up to this many earlier sessions
WARMUP_LAUNCHES = 64
WARMUP_SPAN = "device_trace.warmup"
# the frame kernels' wrappers (K1-K3, the bounce sort's key and permute,
# the sparse NEE sweep, the sparse light walk, the entity triangle sweep),
# whose `launches` count the kernels they launch, by the name their
# kernel's records carry in a trace (no name holds another)
FRAME_KERNELS = {"trace_kernel": window_trace, "shade_kernel": shade_pass,
                 "texel_kernel": texel_fetch, "ray_key_kernel": ray_key,
                 "ray_permute_kernel": ray_permute,
                 "nee_sweep_kernel": nee_sweep,
                 "light_walk_kernel": light_walk,
                 "tri_sweep_kernel": tri_sweep}


def counters() -> Dict[str, int]:
    """A snapshot of the frame path's counters: `host_syncs`,
    `ray_slots`, `rays_alive`, `nee_crossings`, `light_walk_levels`,
    `entity_tris`, the chunk manager's `spans.WORLD_COUNTERS`, and
    `launches.<record name>` of each of FRAME_KERNELS."""
    return {"host_syncs": spans.host_syncs, "ray_slots": spans.ray_slots,
            "rays_alive": spans.rays_alive,
            "nee_crossings": spans.nee_crossings,
            "light_walk_levels": spans.light_walk_levels,
            "entity_tris": spans.entity_tris, **spans.world_counts,
            **{"launches." + k: fn.launches
               for k, fn in FRAME_KERNELS.items()}}


def kernel_records(events: list) -> dict:
    """The frame kernels' records among a Chrome trace's events, by kernel
    name, leaving out the kernels launched inside the warm-up span (a
    launch call and its kernel share a correlation id)."""
    warm = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
            if e.get("name") == WARMUP_SPAN
            and e.get("cat") in ("cpu_op", "user_annotation")]
    warm_ids = {e["args"]["correlation"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})
                and any(lo <= e["ts"] <= hi for lo, hi in warm)}
    counts = dict.fromkeys(FRAME_KERNELS, 0)
    for e in events:
        if e.get("cat") != "kernel" \
                or e.get("args", {}).get("correlation") in warm_ids:
            continue
        for name in FRAME_KERNELS:
            if name in e.get("name", ""):
                counts[name] += 1
    return counts


@contextlib.contextmanager
def device_trace(log_dir: str = TRACE_DIR):
    """Capture a `torch.profiler` timeline (host ops, and the card's
    kernels when CUDA is available) around a code region; on exit it is
    written to `log_dir/trace.json` as a Chrome trace (chrome://tracing,
    Perfetto).  On a card the window opens with `WARMUP_LAUNCHES` empty
    kernels in a span named `WARMUP_SPAN`.  Yields `log_dir`.  The
    program's spans (`span`, `host_sync`) recorded in the region are in
    the trace, on the device records' clock; `counters()` taken before
    and after the region give its syncs, ray slots and launches.

    When the region ends without raising, the frame kernels' launches
    their wrappers counted are held against the kernel records the trace
    holds outside the warm-up span, and a shortfall (records
    torch.profiler lost) is reported with `warnings.warn`, both counts by
    kernel; the trace is written as recorded."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU]
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
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
    before = {k: fn.launches for k, fn in FRAME_KERNELS.items()}
    try:
        yield log_dir
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(path)
    launched = {k: fn.launches - before[k] for k, fn in FRAME_KERNELS.items()}
    if any(launched.values()):
        with open(path) as f:
            recorded = kernel_records(json.load(f)["traceEvents"])
        short = {k: {"launched": launched[k], "recorded": recorded[k]}
                 for k in FRAME_KERNELS if recorded[k] < launched[k]}
        if short:
            warnings.warn(
                f"device_trace: {path} lacks kernel records of launches "
                f"counted in its window (torch.profiler lost them): {short}",
                RuntimeWarning, stacklevel=3)

"""What the sweep tools share (`sort_sweep`, `stage_table`, `fused_ab`,
`trace_tune`, `texel_lab`, `occupancy`, `fusion_probe`): the device they
run on, frame timing on either device, a frame's device time by op and by
kernel from torch.profiler, and its device time by renderer stage.

A tool runs on the card unless asked for the CPU (`device`); on the CPU
the kernels' plain versions run, times are host times and the device
numbers are None.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from wavefront_tpu_torch.kernels.shade import shade_pass
from wavefront_tpu_torch.kernels.texel import texel_fetch
from wavefront_tpu_torch.kernels.window_trace import window_trace
from wavefront_tpu_torch.tools._timing import event, require_card, sync

# K1-K3's wrappers by the name their kernel carries in a profile
KERNELS = {"window_trace": ("trace_kernel", window_trace),
           "shade": ("shade_kernel", shade_pass),
           "texel": ("texel_kernel", texel_fetch)}


def device_of(name: str) -> torch.device:
    """The tool's torch device: a card unless `name` is a CPU; a card that
    is not there raises (SystemExit) rather than falling back."""
    dev = torch.device(name)
    if dev.type == "cuda":
        require_card()
    elif dev.type != "cpu":
        raise SystemExit(f"device {name}: a tool runs on cuda or cpu")
    return dev


def time_frames(renderer, scene, basis, prefs, frames: int) -> float:
    """ms a frame of `renderer`: a first frame (its image must be finite)
    and a settle frame, then `frames` frames on the host clock ended by a
    synchronize, as tools/stage_table.py::time_frames times them."""
    img = renderer.render(scene, basis, prefs, frame_count=0)
    if not np.all(np.isfinite(img)):
        raise FloatingPointError("the first frame is not finite")
    renderer.render(scene, basis, prefs, frame_count=0, as_numpy=False)
    sync(renderer.device)
    t0 = time.perf_counter()
    for f in range(1, frames + 1):
        renderer.render(scene, basis, prefs, frame_count=f, as_numpy=False)
    sync(renderer.device)
    return (time.perf_counter() - t0) * 1e3 / frames


def profile(step, dev, steps: int = 3) -> dict:
    """`step(i)` for i < `steps` under torch.profiler: device busy ms a
    step, device ms a step of each PyTorch op (top 12) and of K1-K3
    (`kernel_ms`), and K1-K3's kernel records beside the launches their
    wrappers counted (torch.profiler may lose the first records of a
    session in a process that read large ones before: `kernel_ms` is then
    the records' mean times the launches).  All None on the CPU."""
    keys = ("device_busy_ms", "device_events_per_frame", "device_ms_by_op",
            "kernel_ms", "kernel_records", "kernel_launches")
    if torch.device(dev).type != "cuda":
        return dict.fromkeys(keys)
    from torch.profiler import ProfilerActivity, profile as torch_profile

    before = {k: fn.launches for k, (_, fn) in KERNELS.items()}
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            step(i)
        sync(dev)
    launched = {k: fn.launches - before[k] for k, (_, fn) in KERNELS.items()}
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    records, kernel_ms = {}, {}
    for k, (name, _) in KERNELS.items():
        times = [e.device_time for e in evs if name in e.name]
        records[k] = len(times)
        kernel_ms[k] = (sum(times) / len(times) * launched[k] / 1e3 / steps
                        if times else 0.0)
    by_op = {}
    for row in prof.key_averages():
        t = row.self_device_time_total / 1e3 / steps
        if row.key.startswith("aten::") and t > 0.0:
            by_op[row.key] = t
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:12]
    return dict(zip(keys, (
        sum(e.device_time for e in evs) / 1e3 / steps, len(evs) / steps,
        dict(top), kernel_ms, records, launched)))


def frame_profile(renderer, scene, basis, prefs, steps: int = 3) -> dict:
    """`profile` of `steps` frames of `renderer` (frame counts 100...)."""
    return profile(lambda i: renderer.render(
        scene, basis, prefs, frame_count=100 + i, as_numpy=False),
        renderer.device, steps)


def stage_times(scene, settings, basis, prefs, frame: int) -> dict:
    """Device ms of one frame by renderer stage: events around the stage
    functions `render.renderer` calls by name (the bounce sort's key, then
    its sort and gathers; the kernels' wrappers included), swapped in for
    this one frame; CUDA events on a card,
    host times on the CPU.  Host gaps inside a stage count toward it; what
    the stages do not cover (raygen, the shade's own elementwise work,
    restore, postprocess) is `other`."""
    from wavefront_tpu_torch.render import renderer as rr

    names = ("bounce_sort_key", "coherence_sort", "window_trace",
             "shade_pass", "texel_fetch", "triangle_sweep",
             "traverse_light_bvh", "dense_sample_light", "nee_pdf_sweep")
    arrays = scene.get_arrays()
    dev = arrays.grid.device
    events = {k: [] for k in names}
    saved = {k: getattr(rr, k) for k in names}

    def timed(fn, name):
        def call(*a, **kw):
            e0, e1 = event(dev), event(dev)
            e0.record()
            r = fn(*a, **kw)
            e1.record()
            events[name].append((e0, e1))
            return r
        return call

    whole = (event(dev), event(dev))
    try:
        for k in names:
            setattr(rr, k, timed(saved[k], k))
        whole[0].record()
        rr.render_frame(
            arrays, basis.eye, basis.front, basis.right, basis.up,
            frame, settings=settings, nee_type=prefs.nee_type,
            sort_type=prefs.sort_type, trace=rr.window_trace,
            shade=rr.shade_pass, texel=rr.texel_fetch,
            use_entities=bool(scene._entities))
        whole[1].record()
        sync(dev)
    finally:
        for k in names:
            setattr(rr, k, saved[k])
    out = {k: sum(a.elapsed_time(b) for a, b in v)
           for k, v in events.items() if v}
    total = whole[0].elapsed_time(whole[1])
    return {"frame_ms": total, "ms_by_stage": out,
            "other_ms": total - sum(out.values())}


def kernel_device_ms(fn, kernel: str, reps: int):
    """Device time of the kernel named `kernel` per launch in `fn`, from
    torch.profiler over `reps` calls: the launch path and the wrapper's
    host time, which CUDA events around a small kernel include, left out;
    with `kernel` "" the time of every kernel `fn` launches, per call.  A
    side measurement for kernels of a few microseconds: None when the
    profiler kept fewer than half of the launches (it may drop the first
    records of a session, see `profile`)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spent = [e.device_time for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and kernel in e.name]
    if len(spent) * 2 <= reps:
        return None
    return sum(spent) / 1e3 / (len(spent) if kernel else reps)

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`wavefront_tpu_torch`) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the two CUDA kernels from `wavefront_tpu_torch/csrc/`, holds each
against its plain PyTorch version on the card at the headline frame's
shapes, renders the golden config-1 scene against the stored image
(tests/golden/config1_256.npz), renders a reduced headline frame through
the kernels and through the plain versions, and then renders the headline
frame itself (1920x1080, 4 bounces, NEE, compaction; bench.py's
headline_setup) through `Renderer.render`, checking that both kernels ran
on every bounce.  Each phase prints one JSON line; the line before the
last lists every kernel with its launches, error, times and bound; the
last line is {"ok": true, "device": {...}}.  Any failed check raises, and
the script exits nonzero without printing that last line; it also exits
nonzero when no CUDA device is present.

Tolerances:
  tracer:  at most 1e-5 of the rays may differ from the plain version in
           pa, pb or t (the coplanar-tie class of docs/PARITY.md);
  shade:   every output within max |diff| 1e-3 and RMS 1e-5 of the plain
           version (the bounds of tests/test_shade_fused.py);
  images:  divergent pixels (max-channel |diff| > 1e-3) under 0.5% and
           RMSE over the agreeing pixels under 1e-3 (tests/test_golden.py).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from wavefront_tpu_torch.core.config import RenderingPreferences, RenderSettings
from wavefront_tpu_torch.core.vec3 import V3
from wavefront_tpu_torch.headline import (
    config1_grid,
    config1_pose,
    headline_setup,
)
from wavefront_tpu_torch.kernels import _build
from wavefront_tpu_torch.kernels.shade import (
    prep_shade_tables,
    shade_pass,
    shade_plain,
)
from wavefront_tpu_torch.kernels.window_trace import auto_events, window_trace
from wavefront_tpu_torch.render.intersect import trace_plain
from wavefront_tpu_torch.render.renderer import (
    Renderer,
    coherence_sort,
    render_frame,
)
from wavefront_tpu_torch.render.scene import VoxelScene
from wavefront_tpu_torch.render.wavefront import raygen_soa
from wavefront_tpu_torch.world.blocks import BlockRegistry

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden", "config1_256.npz")

# H100 SXM published peaks (NVIDIA data sheet, dense): device memory rate
# and float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# float32 operations per unit of work, tallied from the kernel sources
# (compares, selects and arithmetic; integer index math not counted):
# one DDA boundary crossing of the tracer (axis pick 5, crossing-time
# refresh 12, range checks 2)
TRACE_OPS_PER_STEP = 19
# the shade of one live ray without NEE (hit point, face frame, uv,
# emission, scatter, hemisphere sample, branch merge, throughput fold)
SHADE_OPS_PER_RAY = 160
# NEE per hit ray: one branch probability (two box importances, a divide,
# a log) per path node, and a plane/quad test per prim in the pdf sweep
SHADE_OPS_PER_PATH_NODE = 95
SHADE_OPS_PER_PDF_PRIM = 40

TRACE_MISMATCH_FRACTION = 1e-5
SHADE_MAX_ABS = 1e-3
SHADE_RMS = 1e-5


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def sync() -> None:
    torch.cuda.synchronize()


def time_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` back-to-back calls (CUDA
    events), after one warm-up call."""
    fn()
    sync()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    sync()
    return e0.elapsed_time(e1) / reps


def golden_gate(got: np.ndarray, want: np.ndarray, what: str) -> dict:
    check(got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}")
    check(bool(np.all(np.isfinite(got))), f"{what}: image has NaN/Inf")
    diff = np.abs(got - want).max(axis=-1)
    agree = diff < 1e-3
    frac = float(1.0 - agree.mean())
    rmse = float(np.sqrt(np.mean((got[agree] - want[agree]) ** 2)))
    check(frac < 0.005, f"{what}: {frac:.4%} of pixels diverge")
    check(rmse < 1e-3, f"{what}: RMSE {rmse} over agreeing pixels")
    return {"divergent_fraction": frac, "rmse": rmse,
            "max_abs": float(diff.max())}


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def dda_steps(scene, o: V3, d: V3, pa, t) -> int:
    """Voxel boundaries the tracer crosses for these rays: per ray, the
    integer planes between its grid entry and its hit (or its grid exit),
    counted per axis, plus the entry crossing."""
    go = [float(v) for v in scene.grid_origin]
    dims = [float(v) for v in scene.grid.shape]
    p = [o.x - go[0], o.y - go[1], o.z - go[2]]
    dd = [d.x, d.y, d.z]
    near = torch.full_like(t, -3e38)
    far = torch.full_like(t, 3e38)
    for pc, dc, dim in zip(p, dd, dims):
        moving = dc.abs() > 1e-30
        inv = 1.0 / torch.where(moving, dc, torch.ones_like(dc))
        lo, hi = (0.0 - pc) * inv, (dim - pc) * inv
        near = torch.where(moving, torch.maximum(near, torch.minimum(lo, hi)), near)
        far = torch.where(moving, torch.minimum(far, torch.maximum(lo, hi)), far)
    t0 = torch.clamp_min(near, 1e-3)
    t1 = torch.where((pa & 1) != 0, t, torch.clamp_max(far, 1000.0))
    live = (t0 <= t1) & ((dd[0] != 0) | (dd[1] != 0) | (dd[2] != 0))
    steps = torch.zeros_like(t)
    for pc, dc in zip(p, dd):
        steps = steps + (torch.floor(pc + dc * t1) - torch.floor(pc + dc * t0)).abs()
    return int(torch.where(live, steps + 1.0, torch.zeros_like(steps)).sum())


def trace_bound_ms(scene, n: int, steps: int) -> tuple:
    """(bound_ms, bound_by) of the tracer: origin and direction in, pa, pb
    and t out, the grid and class table read once; or its boundary steps."""
    nbytes = n * 36 + scene.grid.numel() + 256
    return max_bound(nbytes, steps * TRACE_OPS_PER_STEP)


def shade_bound_ms(tables, n: int, n_alive: int, n_hit: int,
                   nee: bool) -> tuple:
    """(bound_ms, bound_by) of the shade: 16 words in and 12 out per ray,
    the atlas and light tables read once; or its float32 operations."""
    nbytes = (n * 112 + tables.atlas.numel() * 4 + tables.nodes.numel() * 4
              + tables.prims.numel() * 4)
    ops = n_alive * SHADE_OPS_PER_RAY
    if nee:
        nodes = sum(len(p) for p in tables.paths)
        ops += n_hit * (nodes * SHADE_OPS_PER_PATH_NODE
                        + len(tables.paths) * SHADE_OPS_PER_PDF_PRIM)
    return max_bound(nbytes, ops)


def max_bound(nbytes: int, ops: int) -> tuple:
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def kernel_check(scene, settings, basis) -> dict:
    """K1 and K2 against their plain versions on the card, on the
    headline's bounce-0 rays and on the bounce-1 rays the plain shade makes
    from them, each sorted by the coherence key as the renderer sorts."""
    arrays = scene.get_arrays()
    tables = prep_shade_tables(arrays.atlas_packed, arrays.lights)
    w, h = settings.render_width, settings.render_height
    n = w * h
    o, d, rid = raygen_soa(basis.eye, basis.front, basis.right, basis.up,
                           w, h, device="cuda")
    tp = V3(*(torch.ones(n, device="cuda") for _ in range(3)))
    rad = V3(*(torch.zeros(n, device="cuda") for _ in range(3)))
    events = auto_events(*arrays.grid.shape)
    out = {"rays": n, "bounces": []}
    for b in range(2):
        o, d, tp, rad, rid = coherence_sort(arrays, o, d, tp, rad, rid)
        pa, pb, t = window_trace(arrays, o, d, events)
        qa, qb, qt = trace_plain(arrays, o, d, events)
        sync()
        both = ((pa & 1) != 0) & ((qa & 1) != 0)
        mism = {k: int((x != y).sum()) for k, x, y in
                (("pa", pa, qa), ("pb", pb, qb), ("t", t, qt))}
        limit = TRACE_MISMATCH_FRACTION * n
        check(all(v <= limit for v in mism.values()),
              f"tracer bounce {b}: mismatches {mism} over {limit:.1f}")
        t_err = float((t - qt)[both].abs().max()) if bool(both.any()) else 0.0
        trunc = int(((pa >> 22) & 1).sum())
        check(trunc == 0, f"tracer bounce {b}: {trunc} rays truncated")
        steps = dda_steps(arrays, o, d, qa, qt)

        args = (tables, arrays.grid_origin, o, d, qa, qb, qt, tp, rad, rid,
                b, b, arrays.lights.num_prims)
        got = shade_pass(*args, nee_type=1)
        want = shade_plain(*args, nee_type=1)
        sync()
        s_max, s_rms = 0.0, 0.0
        for kv, pv in zip(got, want):
            for kc, pc in zip(kv, pv):
                df = (kc - pc).abs()
                check(bool(torch.isfinite(kc).all()), f"shade bounce {b}: NaN/Inf")
                s_max = max(s_max, float(df.max()))
                s_rms = max(s_rms, float(df.pow(2).mean().sqrt()))
        check(s_max < SHADE_MAX_ABS and s_rms < SHADE_RMS,
              f"shade bounce {b}: max {s_max} rms {s_rms}")

        alive = int(((d.x != 0) | (d.y != 0) | (d.z != 0)).sum())
        hits = int(((qa & 1) != 0).sum())
        rec = {
            "bounce": b, "alive": alive, "hits": hits, "steps": steps,
            "trace": {"mismatch": mism, "max_abs_err_t": t_err,
                      "ms": time_ms(lambda: window_trace(arrays, o, d, events), 10),
                      "plain_ms": time_ms(lambda: trace_plain(arrays, o, d, events), 1)},
            "shade": {"max_abs_err": s_max, "rms": s_rms,
                      "ms": time_ms(lambda: shade_pass(*args, nee_type=1), 10),
                      "plain_ms": time_ms(lambda: shade_plain(*args, nee_type=1), 1)},
        }
        rec["trace"]["bound_ms"], rec["trace"]["bound_by"] = trace_bound_ms(
            arrays, n, steps)
        rec["shade"]["bound_ms"], rec["shade"]["bound_by"] = shade_bound_ms(
            tables, n, alive, hits, True)
        out["bounces"].append(rec)
        o, d, tp, rad = (V3(*(c.contiguous() for c in v)) for v in want)
    return out


def golden(registry) -> dict:
    blob = np.load(GOLDEN)
    w, h, bounces, nee_type, frame = (int(x) for x in blob["meta"])
    scene = VoxelScene(registry, config1_grid(registry), (0, 0, 0),
                       max_light_prims=256, device="cuda")
    settings = RenderSettings(width=w, height=h, num_bounces=bounces,
                              max_trace_steps=96)
    got = Renderer(settings).render(
        scene, config1_pose(), RenderingPreferences(nee_type=nee_type),
        frame_count=frame)
    return {"width": w, "height": h, "bounces": bounces, "nee_type": nee_type,
            **golden_gate(got, blob["image"], "golden config-1")}


def frame_check() -> dict:
    scene, settings, basis, prefs = headline_setup(480, 270, 4, device="cuda")
    got = Renderer(settings).render(scene, basis, prefs, frame_count=1)
    want, _ = render_frame(
        scene.get_arrays(), basis.eye, basis.front, basis.right, basis.up, 1,
        settings=settings, nee_type=prefs.nee_type, sort_type=prefs.sort_type,
        trace=trace_plain, shade=shade_plain)
    return {"width": 480, "height": 270, "bounces": 4,
            **golden_gate(got, want.cpu().numpy(), "frame kernels vs plain")}


def timed_frame(scene, settings, basis, prefs, frame: int) -> dict:
    """One headline frame with CUDA events around every kernel launch."""
    events = {"window_trace": [], "shade": []}

    def timed(fn, name):
        def call(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            r = fn(*a, **kw)
            e1.record()
            events[name].append((e0, e1, int(a[2].x.shape[0]) if name == "shade"
                                 else int(a[1].x.shape[0])))
            return r
        return call

    render_frame(scene.get_arrays(), basis.eye, basis.front, basis.right,
                 basis.up, frame, settings=settings, nee_type=prefs.nee_type,
                 sort_type=prefs.sort_type,
                 trace=timed(window_trace, "window_trace"),
                 shade=timed(shade_pass, "shade"))
    sync()
    return {k: [{"rays": m, "ms": a.elapsed_time(b)} for a, b, m in v]
            for k, v in events.items()}


def profile_frames(scene, settings, basis, prefs, frame_ms: float,
                   frames: int = 3) -> dict:
    """Where a headline frame's device time goes: `frames` frames under
    torch.profiler; device time per frame by PyTorch op (the two kernels'
    launches appear under their own names) and the device's idle share
    of the unprofiled frame time."""
    from torch.profiler import ProfilerActivity, profile

    r = Renderer(settings)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for f in range(frames):
            r.render(scene, basis, prefs, frame_count=100 + f, as_numpy=False)
        sync()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.device_time for e in dev) / 1e3 / frames
    check(busy_ms > 0.0, "the profiler saw no device time")
    ours = {"window_trace": "trace_kernel", "shade": "shade_kernel"}
    by_op = {k: sum(e.device_time for e in dev if v in e.name) / 1e3 / frames
             for k, v in ours.items()}
    for row in prof.key_averages():
        t = row.self_device_time_total / 1e3 / frames
        if row.key.startswith("aten::") and t > 0.0:
            by_op[row.key] = t
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:12]
    return {"frames": frames, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / frame_ms),
            "device_events_per_frame": len(dev) / frames,
            "device_ms_by_op": dict(top)}


def headline(scene, settings, basis, prefs, name: str, limit: str) -> dict:
    r = Renderer(settings)
    # the main path, with every launch counter at 0 just before it
    window_trace.launches = 0
    shade_pass.launches = 0
    img, aux = r.render(scene, basis, prefs, frame_count=0, as_numpy=False,
                        with_aux=True)
    sync()
    launches = {"window_trace": window_trace.launches,
                "shade": shade_pass.launches}
    check(bool(torch.isfinite(img).all()), "headline image has NaN/Inf")
    mean = float(img.mean())
    check(mean > 0.0, f"headline image mean {mean}")
    check(aux["truncated"] == 0, f"headline truncated {aux['truncated']}")
    nb = settings.num_bounces
    check(launches == {"window_trace": nb, "shade": nb},
          f"headline launches {launches}, want {nb} each")

    frames = 5
    sync()
    t0 = time.perf_counter()
    for f in range(1, frames + 1):
        img, aux = r.render(scene, basis, prefs, frame_count=f,
                            as_numpy=False, with_aux=True)
    sync()
    frame_ms = (time.perf_counter() - t0) * 1e3 / frames
    check(aux["truncated"] == 0, f"headline truncated {aux['truncated']}")
    rays = settings.n_rays * nb
    per_launch = timed_frame(scene, settings, basis, prefs, frames + 1)
    return {
        "card": name, "power_limit": limit,
        "width": settings.width, "height": settings.height, "bounces": nb,
        "image_mean": mean, "truncated": aux["truncated"],
        "launches": launches, "frames_timed": frames,
        "frame_ms": frame_ms, "Mrays_per_sec": rays / frame_ms / 1e3,
        "per_launch": per_launch,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = card()
    name, limit = (s.strip() for s in smi.split(",", 1))
    t0 = time.perf_counter()
    _build.build_all()
    emit("device", card=name, power_limit=limit,
         kind=torch.cuda.get_device_name(0), torch=torch.__version__,
         cuda=torch.version.cuda, build_s=time.perf_counter() - t0)

    scene, settings, basis, prefs = headline_setup(1920, 1080, 4,
                                                   device="cuda")
    kc = kernel_check(scene, settings, basis)
    emit("kernel_check", **kc)
    emit("golden", **golden(BlockRegistry.load(os.path.join(HERE, "assets"))))
    emit("frame_check", **frame_check())
    hl = headline(scene, settings, basis, prefs, name, limit)
    b0 = kc["bounces"][0]
    emit("headline", **hl, plain_ms_bounce0={
        "window_trace": b0["trace"]["plain_ms"],
        "shade": b0["shade"]["plain_ms"]})
    emit("profile", **profile_frames(scene, settings, basis, prefs,
                                     hl["frame_ms"]))

    kernels = []
    for kname, key, src, replaces in (
        ("window_trace", "trace", "wavefront_tpu_torch/csrc/window_trace.cu",
         "wavefront_tpu/kernels/window_trace.py:765"),
        ("shade", "shade", "wavefront_tpu_torch/csrc/shade.cu",
         "wavefront_tpu/kernels/shade.py:261"),
    ):
        k = b0[key]
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": hl["launches"][kname],
            "max_abs_err": k.get("max_abs_err_t", k.get("max_abs_err")),
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`wavefront_tpu_torch`) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the three CUDA kernels from `wavefront_tpu_torch/csrc/`, holds
each against its plain PyTorch version on the card at the shapes its frame
gives it, renders the golden config-1 scene against the stored image
(tests/golden/config1_256.npz), renders reduced frames through the
kernels and through the plain versions, and then renders two full frames
through `Renderer.render`, checking which kernels ran on every bounce:

  * the headline frame (1920x1080, 4 bounces, NEE, compaction; bench.py's
    headline_setup): the tracer and the fused shade;
  * the general frame (`headline.general_setup`: the same frame with a
    sparse light set of lamp voxels and a cube entity, shade_fused=False):
    the tracer and the texel fetch, and never the fused shade.

Each phase prints one JSON line; the line before the last lists every
kernel with its launches, error, times and bound; the last line is
{"ok": true, "device": {...}}.  Any failed check raises, and the script
exits nonzero without printing that last line; it also exits nonzero when
no CUDA device is present.

Tolerances:
  tracer:  at most 1e-5 of the rays may differ from the plain version in
           pa, pb or t (the coplanar-tie class of docs/PARITY.md);
  shade:   every output within max |diff| 1e-3 and RMS 1e-5 of the plain
           version (the bounds of tests/test_shade_fused.py), with and
           without the entity attribute stream;
  texel:   max |diff| 0 against the plain version (a fetch copies float32
           values), non-finite and out-of-range inputs included;
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
    add_ego_cube,
    config1_grid,
    config1_pose,
    general_setup,
    headline_setup,
)
from wavefront_tpu_torch.kernels import _build
from wavefront_tpu_torch.kernels.shade import (
    prep_shade_tables,
    shade_pass,
    shade_plain,
)
from wavefront_tpu_torch.kernels.texel import (
    texel_fetch,
    texel_index,
    texel_plain,
)
from wavefront_tpu_torch.kernels.window_trace import auto_events, window_trace
from wavefront_tpu_torch.render.intersect import trace_plain
from wavefront_tpu_torch.render.renderer import (
    Renderer,
    coherence_sort,
    entity_attrs,
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
# the texel fetch of one ray: two multiplies and the float side of two
# saturating conversions and clamps
TEXEL_OPS_PER_RAY = 8

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
                   nee: bool, n_entity=None) -> tuple:
    """(bound_ms, bound_by) of the shade: 16 words in and 12 out per ray,
    the atlas and light tables read once; or its float32 operations.
    With the entity stream (n_entity: the lanes an entity wins) the flag
    word is read on every ray and the other 11 words on those lanes."""
    stream = 0 if n_entity is None else n * 4 + n_entity * 44
    nbytes = (n * 112 + stream + tables.atlas.numel() * 4
              + tables.nodes.numel() * 4 + tables.prims.numel() * 4)
    ops = n_alive * SHADE_OPS_PER_RAY
    if nee:
        nodes = sum(len(p) for p in tables.paths)
        ops += n_hit * (nodes * SHADE_OPS_PER_PATH_NODE
                        + len(tables.paths) * SHADE_OPS_PER_PDF_PRIM)
    return max_bound(nbytes, ops)


def texel_bound_ms(atlas, n: int, nch: int) -> tuple:
    """(bound_ms, bound_by) of the texel fetch: tex, u and v in and nch
    floats out per ray, the atlas read once; or its float32 operations."""
    return max_bound(n * (12 + 4 * nch) + atlas.numel() * 4,
                     n * TEXEL_OPS_PER_RAY)


def max_bound(nbytes: int, ops: int) -> tuple:
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def trace_check(arrays, o: V3, d: V3, events: int, what: str) -> dict:
    """K1 against its plain version on one set of rays: the mismatch
    counts (held under TRACE_MISMATCH_FRACTION), the largest |t| error on
    common hits, the plain version's words and the boundary steps."""
    n = o.x.shape[0]
    pa, pb, t = window_trace(arrays, o, d, events)
    qa, qb, qt = trace_plain(arrays, o, d, events)
    sync()
    both = ((pa & 1) != 0) & ((qa & 1) != 0)
    mism = {k: int((x != y).sum()) for k, x, y in
            (("pa", pa, qa), ("pb", pb, qb), ("t", t, qt))}
    limit = TRACE_MISMATCH_FRACTION * n
    check(all(v <= limit for v in mism.values()),
          f"tracer {what}: mismatches {mism} over {limit:.1f}")
    t_err = float((t - qt)[both].abs().max()) if bool(both.any()) else 0.0
    trunc = int(((pa >> 22) & 1).sum())
    check(trunc == 0, f"tracer {what}: {trunc} rays truncated")
    return {"mismatch": mism, "max_abs_err_t": t_err,
            "plain": (qa, qb, qt),
            "steps": dda_steps(arrays, o, d, qa, qt)}


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
        tr = trace_check(arrays, o, d, events, f"bounce {b}")
        qa, qb, qt = tr.pop("plain")
        steps = tr.pop("steps")

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
            "trace": {**tr,
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


def texel_check(scene, settings, basis, prefs) -> dict:
    """K3 against its plain version on the card: on the (tex, u, v) the
    general frame's first bounce hands it (miss lanes carry huge u, v), and
    on a seeded set of the same size with out-of-range slots, coordinates
    past both edges and non-finite lanes.  Times are of the first.  Also
    K1 against its plain version on the rays the general frame's first two
    bounces hand it (the grid with the lamp lattice; bounce 1 leaves voxel
    faces, lamps and the cube)."""
    seen, traced = [], []

    def spy(atlas, tex, u, v, channels=None):
        seen.append((atlas, tex, u, v, tuple(channels)))
        return texel_fetch(atlas, tex, u, v, channels=channels)

    def trace_spy(arrays, o, d, events):
        traced.append((arrays, o, d, events))
        return window_trace(arrays, o, d, events)

    render_frame(scene.get_arrays(), basis.eye, basis.front, basis.right,
                 basis.up, 0, settings=settings.replace(num_bounces=2),
                 nee_type=prefs.nee_type, sort_type=prefs.sort_type,
                 trace=trace_spy, texel=spy)
    check(len(seen) == 2 and len(traced) == 2,
          f"a 2-bounce frame fetched {len(seen)} and traced {len(traced)} times")
    atlas, tex, u, v, chans = seen[0]
    n = tex.shape[0]
    check(n == settings.n_rays, f"texel rays {n} != {settings.n_rays}")
    g = torch.Generator(device="cpu").manual_seed(0)
    n_tex = atlas.shape[0]
    tex2 = torch.randint(-50, n_tex + 50, (n,), generator=g,
                         dtype=torch.int32)
    uv2 = torch.rand((2, n), generator=g) * 1.2 - 0.1
    odd = torch.tensor([float("nan"), float("inf"), float("-inf"), 3e38,
                        -3e38, 1e10, -1e10])
    lanes = torch.randint(0, n, (2, 70000), generator=g)
    uv2[0, lanes[0]] = odd.repeat(10000)
    uv2[1, lanes[1]] = odd.repeat(10000).flip(0)
    sets = {"frame": (tex, u, v),
            "seeded": (tex2.cuda(), uv2[0].cuda().contiguous(),
                       uv2[1].cuda().contiguous())}
    out = {"rays": n, "channels": list(chans), "trace": []}
    for b, rays in enumerate(traced):
        tr = trace_check(*rays, f"general bounce {b}")
        del tr["plain"]
        out["trace"].append({"bounce": b, "rays": int(rays[1].x.shape[0]),
                             **tr})
    for name, (a, b, c) in sets.items():
        got = texel_fetch(atlas, a, b, c, channels=chans)
        want = texel_plain(atlas, a, b, c, channels=chans)
        sync()
        check(got.shape == (len(chans), n), f"texel {name}: shape {got.shape}")
        check(bool(torch.isfinite(got).all()), f"texel {name}: NaN/Inf")
        err = float((got - want).abs().max())
        check(err == 0.0, f"texel {name}: max |diff| {err} against plain")
        out[f"max_abs_err_{name}"] = err
    out["max_abs_err"] = max(out["max_abs_err_frame"],
                             out["max_abs_err_seeded"])
    out["non_finite_uv_frame"] = int((~torch.isfinite(u) | ~torch.isfinite(v)
                                      ).sum())
    ch = list(chans)
    out["ms"] = time_ms(lambda: texel_fetch(atlas, tex, u, v, channels=chans),
                        20)
    out["plain_ms"] = time_ms(
        lambda: texel_plain(atlas, tex, u, v, channels=chans), 5)
    # the fetch through PyTorch's indexed read: the index arithmetic, the
    # read, the channel select and the transpose to channel-major (what
    # texel_plain does); and the read alone on indices made beforehand
    out["library_ms"] = time_ms(
        lambda: atlas[texel_index(atlas, tex, u, v)][:, ch].t().contiguous(),
        5)
    index = texel_index(atlas, tex, u, v)
    out["indexed_read_ms"] = time_ms(
        lambda: atlas[index][:, ch].t().contiguous(), 5)
    out["bound_ms"], out["bound_by"] = texel_bound_ms(atlas, n, len(chans))
    return out


def shade_tri_check() -> dict:
    """K2 with the entity attribute stream against its plain version, on
    the bounce-0 rays of the headline frame with the ego cube in view."""
    scene, settings, basis, _ = headline_setup(1920, 1080, 4, device="cuda")
    add_ego_cube(scene, basis)
    arrays = scene.get_arrays()
    tables = prep_shade_tables(arrays.atlas_packed, arrays.lights)
    w, h = settings.render_width, settings.render_height
    n = w * h
    o, d, rid = raygen_soa(basis.eye, basis.front, basis.right, basis.up,
                           w, h, device="cuda")
    tp = V3(*(torch.ones(n, device="cuda") for _ in range(3)))
    rad = V3(*(torch.zeros(n, device="cuda") for _ in range(3)))
    o, d, tp, rad, rid = coherence_sort(arrays, o, d, tp, rad, rid)
    pa, pb, t = window_trace(arrays, o, d, auto_events(*arrays.grid.shape))
    t, tri_attrs = entity_attrs(arrays, o, d, pa, t)
    use_tri = int(((tri_attrs[11] >> 16) & 1).sum())
    check(use_tri > n // 200, f"the cube wins only {use_tri} of {n} rays")
    args = (tables, arrays.grid_origin, o, d, pa, pb, t, tp, rad, rid, 0, 0,
            arrays.lights.num_prims)
    got = shade_pass(*args, nee_type=1, tri_attrs=tri_attrs)
    want = shade_plain(*args, nee_type=1, tri_attrs=tri_attrs)
    bare = shade_pass(*args, nee_type=1)
    sync()
    s_max, s_rms = 0.0, 0.0
    for kv, pv in zip(got, want):
        for kc, pc in zip(kv, pv):
            df = (kc - pc).abs()
            check(bool(torch.isfinite(kc).all()), "shade with entities: NaN/Inf")
            s_max = max(s_max, float(df.max()))
            s_rms = max(s_rms, float(df.pow(2).mean().sqrt()))
    check(s_max < SHADE_MAX_ABS and s_rms < SHADE_RMS,
          f"shade with entities: max {s_max} rms {s_rms}")
    check(not torch.equal(got[1].x, bare[1].x),
          "the entity stream changed nothing")
    hits = int((((pa & 1) != 0) | (((tri_attrs[11] >> 16) & 1) != 0)).sum())
    out = {"rays": n, "entity_hits": use_tri, "max_abs_err": s_max,
           "rms": s_rms,
           "ms": time_ms(lambda: shade_pass(*args, nee_type=1,
                                            tri_attrs=tri_attrs), 10),
           "ms_without_stream": time_ms(
               lambda: shade_pass(*args, nee_type=1), 10)}
    out["bound_ms"], out["bound_by"] = shade_bound_ms(
        tables, n, n, hits, True, n_entity=use_tri)
    return out


def general_check() -> dict:
    """Reduced frames (480x270, 4 bounces) under the golden gate: the
    general frame through the kernels against the plain versions, and the
    headline scene with the ego cube on the fused path (K2 with the entity
    stream) against the general path (K3)."""
    def plain_frame(scene, settings, basis, prefs):
        img, aux = render_frame(
            scene.get_arrays(), basis.eye, basis.front, basis.right,
            basis.up, 1, settings=settings, nee_type=prefs.nee_type,
            sort_type=prefs.sort_type, trace=trace_plain, shade=shade_plain,
            texel=texel_plain)
        return img.cpu().numpy(), aux

    scene, settings, basis, prefs = general_setup(480, 270, 4, device="cuda")
    got, aux = Renderer(settings).render(scene, basis, prefs, frame_count=1,
                                         with_aux=True)
    want, aux_plain = plain_frame(scene, settings, basis, prefs)
    check(aux == aux_plain == {"truncated": 0, "nee_overflow": 0},
          f"general 480x270 audit {aux} / {aux_plain}")
    out = {"width": 480, "height": 270, "bounces": 4,
           "general_kernels_vs_plain": golden_gate(
               got, want, "general frame kernels vs plain")}

    scene, settings, basis, prefs = headline_setup(480, 270, 4, device="cuda")
    add_ego_cube(scene, basis)
    fused = Renderer(settings).render(scene, basis, prefs, frame_count=1)
    general = Renderer(settings.replace(shade_fused=False)).render(
        scene, basis, prefs, frame_count=1)
    out["entity_fused_vs_general"] = golden_gate(
        fused, general, "entity frame fused vs general")
    bare = Renderer(settings).render(
        headline_setup(480, 270, 4, device="cuda")[0], basis, prefs,
        frame_count=1)
    check(not np.array_equal(fused, bare), "the cube changed no pixel")
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
    """One frame with CUDA events around every kernel launch."""
    events = {"window_trace": [], "shade": [], "texel": []}
    # position of an (N,) ray tensor or V3 among each wrapper's arguments
    ray_arg = {"window_trace": 1, "shade": 2, "texel": 1}

    def timed(fn, name):
        def call(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            r = fn(*a, **kw)
            e1.record()
            rays = a[ray_arg[name]]
            events[name].append(
                (e0, e1, int((rays.x if isinstance(rays, V3) else rays
                              ).shape[0])))
            return r
        return call

    render_frame(scene.get_arrays(), basis.eye, basis.front, basis.right,
                 basis.up, frame, settings=settings, nee_type=prefs.nee_type,
                 sort_type=prefs.sort_type,
                 trace=timed(window_trace, "window_trace"),
                 shade=timed(shade_pass, "shade"),
                 texel=timed(texel_fetch, "texel"))
    sync()
    return {k: [{"rays": m, "ms": a.elapsed_time(b)} for a, b, m in v]
            for k, v in events.items() if v}


def stage_times(scene, settings, basis, prefs, frame: int) -> dict:
    """Device ms of one frame by renderer stage: CUDA events around the
    stage functions `render.renderer` calls by name (the kernels' wrappers
    included), swapped in for this one frame.  Host gaps inside a stage
    count toward it; what the stages do not cover (raygen, the shade's own
    elementwise work, restore, postprocess) is `other`."""
    from wavefront_tpu_torch.render import renderer as rr

    names = ("coherence_sort", "window_trace", "shade_pass", "texel_fetch",
             "triangle_sweep", "traverse_light_bvh", "dense_sample_light",
             "nee_pdf_sweep")
    events = {k: [] for k in names}
    saved = {k: getattr(rr, k) for k in names}

    def timed(fn, name):
        def call(*a, **kw):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            r = fn(*a, **kw)
            e1.record()
            events[name].append((e0, e1))
            return r
        return call

    whole = (torch.cuda.Event(enable_timing=True),
             torch.cuda.Event(enable_timing=True))
    try:
        for k in names:
            setattr(rr, k, timed(saved[k], k))
        whole[0].record()
        rr.render_frame(
            scene.get_arrays(), basis.eye, basis.front, basis.right, basis.up,
            frame, settings=settings, nee_type=prefs.nee_type,
            sort_type=prefs.sort_type, trace=rr.window_trace,
            shade=rr.shade_pass, texel=rr.texel_fetch)
        whole[1].record()
        sync()
    finally:
        for k in names:
            setattr(rr, k, saved[k])
    out = {k: sum(a.elapsed_time(b) for a, b in v)
           for k, v in events.items() if v}
    total = whole[0].elapsed_time(whole[1])
    return {"frame_ms": total, "ms_by_stage": out,
            "other_ms": total - sum(out.values())}


def profile_frames(scene, settings, basis, prefs, frame_ms: float,
                   frames: int = 3) -> dict:
    """Where a frame's device time goes: `frames` frames under
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
    ours = {"window_trace": "trace_kernel", "shade": "shade_kernel",
            "texel": "texel_kernel"}
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


def full_frame(what: str, scene, settings, basis, prefs, name: str,
               limit: str, kernels: tuple, frames: int) -> dict:
    """A main path at full size through `Renderer.render`: one frame with
    every launch counter at 0 just before it, which must launch each of
    `kernels` once per bounce and no other; then `frames` timed frames and
    one with CUDA events around each launch."""
    r = Renderer(settings)
    wrappers = {"window_trace": window_trace, "shade": shade_pass,
                "texel": texel_fetch}
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    img, aux = r.render(scene, basis, prefs, frame_count=0, as_numpy=False,
                        with_aux=True)
    sync()
    launches = {k: fn.launches for k, fn in wrappers.items()}
    check(tuple(img.shape) == (settings.height, settings.width, 3),
          f"{what} image shape {tuple(img.shape)}")
    check(bool(torch.isfinite(img).all()), f"{what} image has NaN/Inf")
    mean = float(img.mean())
    check(mean > 0.0, f"{what} image mean {mean}")
    audit = {"truncated": 0, "nee_overflow": 0}
    check(aux == audit, f"{what} audit {aux}")
    nb = settings.num_bounces
    want = {k: nb if k in kernels else 0 for k in wrappers}
    check(launches == want, f"{what} launches {launches}, want {want}")

    sync()
    t0 = time.perf_counter()
    for f in range(1, frames + 1):
        img, aux = r.render(scene, basis, prefs, frame_count=f,
                            as_numpy=False, with_aux=True)
    sync()
    frame_ms = (time.perf_counter() - t0) * 1e3 / frames
    check(aux == audit, f"{what} audit {aux}")
    rays = settings.n_rays * nb
    per_launch = timed_frame(scene, settings, basis, prefs, frames + 1)
    return {
        "card": name, "power_limit": limit,
        "width": settings.width, "height": settings.height, "bounces": nb,
        "image_mean": mean, **aux,
        "launches": launches, "frames_timed": frames,
        "frame_ms": frame_ms, "Mrays_per_sec": rays / frame_ms / 1e3,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
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
    gen = general_setup(1920, 1080, 4, device="cuda")
    tc = texel_check(*gen)
    emit("texel_check", **tc)
    emit("shade_tri_check", **shade_tri_check())
    emit("general_check", **general_check())
    hl = full_frame("headline", scene, settings, basis, prefs, name, limit,
                    ("window_trace", "shade"), frames=5)
    b0 = kc["bounces"][0]
    emit("headline", **hl, plain_ms_bounce0={
        "window_trace": b0["trace"]["plain_ms"],
        "shade": b0["shade"]["plain_ms"]})
    emit("profile", **profile_frames(scene, settings, basis, prefs,
                                     hl["frame_ms"]))
    lights = gen[0].get_arrays().lights
    gf = full_frame("general", *gen, name, limit, ("window_trace", "texel"),
                    frames=3)
    emit("general", **gf, max_nee_hits=gen[1].max_nee_hits, light_set={
        "num_prims": lights.num_prims, "prim_bucket": lights.p0.shape[0],
        "node_bucket": lights.node_min.shape[0], "dense": lights.dense})
    emit("general_profile", **profile_frames(*gen, gf["frame_ms"], frames=2),
         stages=stage_times(*gen, 10))

    kernels = []
    for kname, k, src, replaces, path in (
        ("window_trace", b0["trace"],
         "wavefront_tpu_torch/csrc/window_trace.cu",
         "wavefront_tpu/kernels/window_trace.py:765", hl),
        ("shade", b0["shade"], "wavefront_tpu_torch/csrc/shade.cu",
         "wavefront_tpu/kernels/shade.py:261", hl),
        ("texel", tc, "wavefront_tpu_torch/csrc/texel.cu",
         "wavefront_tpu/kernels/texel.py:47", gf),
    ):
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": path["launches"][kname],
            "launches_by_path": {"headline": hl["launches"][kname],
                                 "general": gf["launches"][kname]},
            "max_abs_err": k.get("max_abs_err_t", k.get("max_abs_err")),
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k.get("library_ms"),
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`wavefront_tpu_torch`) on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernels of `wavefront_tpu_torch/csrc/`, holds each
against its plain PyTorch version on the card at the shapes its path
gives it, renders the golden config-1 scene against the stored image
(tests/golden/config1_256.npz), renders reduced frames through the
kernels and through the plain versions, and then drives the main paths
through their entry points, checking which kernels each launched:

  * the headline frame (1920x1080, 4 bounces, NEE, compaction; bench.py's
    headline_setup) through `Renderer.render`: the tracer and the fused
    shade; then the same frame with shade_bf16 (`headline_bf16`): the
    tracer and the fused shade's bf16 color build;
  * the general frame (`headline.general_setup`: the same frame with a
    sparse light set of lamp voxels and a cube entity, shade_fused=False):
    the tracer, the texel fetch and the sparse NEE sweep, and never the
    fused shade;
  * the four labs (`wavefront_tpu_torch/tools/`: radix_lab, gpu_probe,
    roofline, event_lab) at full size: the histogram and the three probe
    kernels;
  * the batched frame: the headline scene with `cache_primary`, through
    `Renderer.render_batch(k=4)` as a stack and as a mean, held bit for
    bit against four `render` calls; a frame that fills the primary cache
    launches the tracer once per bounce, a cached frame once less;
  * the scene edits and the game layer (tools/bench_ladder.py configs 4
    and 6-8): the headline frame with a block edit before each frame
    (`edit`); the streamed window of `headline.streamed_setup` (load
    radius 6, 416x96x416) at 1920x1080 (`streamed`), with an edit a frame
    through the chunk manager (`streamed_edit`), and at 1024x1024 with 6
    bounces and a recenter adopted from the background rebuild
    (`streamed_1024x6`); and `GameWorld.step` at 1920x1080 with a block
    placed, a block broken through the mouse ray and a recenter (`game`).
    Each holds its device grid and aux grid equal to `make_aux_grid` of
    its host grid (and a window assembled from scratch) and its last
    frame equal bit for bit to the frame of a scene built afresh; on the
    streamed window's four sorted bounces the bounce sort's key and
    permute kernels against their plain versions (`ray_sort_check`); on
    the lamp-lit window's four bounces (`headline.lamps_setup`) the
    sparse NEE sweep's kernel against its plain version
    (`nee_sweep_check`);
  * the last modules: the app (`app.main.main` at its defaults,
    1024x1024, 6 bounces, `--window-chunks 2`, 20 frames with a
    screenshot every 10, then 8 frames of `--accumulate --hold`, each
    frame after the first reusing the primary hits; K1 and K2 held
    against their plain versions on every call of a frame of the app's
    final scene) and its `viewer` (the frame's PNG, `GET /frame` and
    `POST /input` over loopback); a
    checkpoint of the app's world loaded into a new one (`persistence`:
    grids and a frame equal); the headline frame over pixel ranges
    (`distributed`: `DistributedRenderer` over two ranges on the card and
    over `make_mesh()`, equal bit for bit to `Renderer.render`); the sort
    utilities on 2,073,600 keys against numpy (`sort`); the NaN checks of
    the validation layer on K3, a tensor op and a 480x270 frame
    (`validation`); `device_trace` around a headline frame in five
    sessions, after the script's many others, its K1 and K2 events
    counted (`profiling`); and the native chunk generator
    against its NumPy version (`worldgen`);
  * the benchmark ladder (`wavefront_tpu_torch/tools/bench_ladder.py`,
    the port of tools/bench_ladder.py), configs 1-8 at their own sizes
    (`ladder`): each config's row with its launches, one frame's launches
    with the trace audit on, device busy ms and idle share, and the card,
    on a line of its own (`ladder_row`); config 1's k=8 stack and config
    5's k=8 accumulating batch (2560x1440, 8 bounces) equal to 8 single
    frames bit for bit; every K1 and K2 call of a frame of configs 1, 2
    (K2 at nee_type 0) and 5 (the frame that fills the primary cache and
    a cached one) held against the plain versions;
  * the sweep tools (`wavefront_tpu_torch/tools/`: sort_sweep,
    stage_table, fused_ab, texel_lab, trace_tune, occupancy and
    fusion_probe, the ports of the JAX package's tools) at full width
    (`sweeps`): the headline over the `sort_bounces` schedules, with one
    stage varied (no sort, K1's unskipped march, ...), fused against
    general, over compaction x trace_skips x trace_presort; K3 against
    the gather it replaces; K1's lane occupancy on the headline's and the
    streamed window's rays; the tiles' decay without a re-sort.  Each row
    on a line of its own (`sweep_row`);
  * the repository's last tools, ported (`wavefront_tpu_torch/bench.py`
    and `tools/`: gpu_parity, parity_probe, gen_golden, gen_assets,
    onehot_ab, prewarm, gpu_sweep) at full width (`tools`): the headline
    benchmark's Mrays/s (10 frames in batches of 5), the golden and bench
    parity gates, the six parity probes on the golden scene (arms, tracer
    fields, the primary cache, card against CPU), the oracle's golden and
    the asset pack regenerated under build/chip_smoke/ and held to the
    stored ones, K1 and K5's table-lookup forms at the headline's ray
    count, the programs of prewarm, and `gpu_sweep --stages gates` as a
    subprocess.  Each row on a line of its own (`tools_row`).

Each phase prints one JSON line with the seconds it took, then a line of
the seconds by phase and in total; the line before the last lists every
kernel with its launches, error, times and bound; the last line is
{"ok": true, "device": {...}}.  Any failed check raises, and the script
exits nonzero without printing that last line; it also exits nonzero when
no CUDA device is present.

Tolerances:
  tracer:  at most 1e-5 of the rays may differ from the plain version in
           pa, pb or t (the coplanar-tie class of docs/PARITY.md), both
           from its skipping march and from its unskipped one (a skip's
           landing may fall a voxel off the exact path beside a grazed
           edge);
  shade:   every output within max |diff| 1e-3 and RMS 1e-5 of the plain
           version (the bounds of tests/test_shade_fused.py), with and
           without the entity attribute stream; in the bf16 color build
           (shade_bf16) tp (bfloat16) within 1 bfloat16 ulp and radiance
           within 1 bfloat16 ulp of its bfloat16 term tp * emission, the
           rest as above (a float32 value that cos, sin, log or exp round
           an ulp apart in CUDA and PyTorch may cross a bfloat16 rounding
           boundary; expected: equal);
  texel:   max |diff| 0 against the plain version (a fetch copies float32
           values), non-finite and out-of-range inputs included;
  images:  divergent pixels (max-channel |diff| > 1e-3) under 0.5% and
           RMSE over the agreeing pixels under 1e-3 (tests/test_golden.py);
  histogram and probes: max |diff| 0 against the plain versions (integer
           results; the float32 add chain runs in one fixed order);
  batch:   the batched frames equal the single frames bit for bit, their
           mean equal to the single frames' sum in frame order over k bit
           for bit (render_frame_batch sums in that order), a cached
           frame within
           max |diff| 1e-3 and RMS 1e-5 of the uncached frame of its seed;
  edits:   grid and aux grid exactly equal; a frame after edits or a
           recenter equal bit for bit to a fresh scene's (no per-ray
           result depends on how the scene arrays were built);
  ray sort: the bounce sort's keys, permutations and permuted columns
           equal bit for bit to the plain versions' and the 64-bit key's
           (the key repeats the plain version's float32 operations);
  NEE sweep: crossings and overflowing rays equal to the plain
           version's, a ray with one crossing bit for bit, every pdf
           within 1e-6 relative (the kernel sums a ray's slots in slot
           order, the plain version by PyTorch's reduction);
  ranges, checkpoints, sort, worldgen: equal bit for bit (no ray reads
           another ray; the rest is integer or host code);
  sweeps:  every sort schedule's image, and the image without a sort,
           within max |diff| 1e-5 of the every-bounce sort's (the bound
           of tests/test_golden.py's schedule test; per-ray results do not
           depend on ray order), no ray truncated; the unskipped march's
           image under the image gate above against the skipping one's.
  tools:   the golden and bench gates of tools/tpu_parity.py (a pixel
           agrees within 1e-3 * max(1, |want|); under 0.5% divergent,
           relative RMSE under 1e-3), no truncated or overflowing ray;
           the probes' primary cache 0 divergent pixels, tracer fields
           off on at most 1e-5 of the rays, card against CPU under the
           golden gate; the oracle's golden within 1e-6 * max(1, |want|)
           of the stored one (expected: equal); the asset pack's
           blocks.json byte for byte and every texture's RGBA equal; K5's
           forms equal to the indexed read.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from wavefront_tpu_torch import bench
from wavefront_tpu_torch.core.config import (
    EPSILON_NEE,
    T_MAX,
    RenderingPreferences,
    RenderSettings,
)
from wavefront_tpu_torch.core.vec3 import V3
from wavefront_tpu_torch.headline import (
    HEADLINE_RAYS,
    add_ego_cube,
    config1_grid,
    config1_pose,
    general_setup,
    headline_setup,
    lamps_setup,
    streamed_setup,
)
from wavefront_tpu_torch.kernels import (
    _build,
    device_probe,
    extract_probe,
    loop_probe,
)
from wavefront_tpu_torch.kernels import radix_hist as rh
from wavefront_tpu_torch.kernels.nee_sweep import nee_sweep
from wavefront_tpu_torch.kernels.ray_sort import (
    ray_key,
    ray_key_plain,
    ray_permute,
    ray_permute_plain,
)
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
from wavefront_tpu_torch.kernels.window_trace import (
    auto_events,
    coherence_key,
    window_trace,
)
from wavefront_tpu_torch.render import renderer as rr
from wavefront_tpu_torch.render.intersect import make_aux_grid, trace_plain
from wavefront_tpu_torch.render.renderer import (
    Renderer,
    coherence_sort,
    entity_attrs,
    render_frame,
)
from wavefront_tpu_torch.render.accumulate import TemporalAccumulator
from wavefront_tpu_torch.render.scene import VoxelScene
from wavefront_tpu_torch.render.wavefront import (
    _prim_tile_hits,
    nee_sweep_plain,
    raygen_soa,
)
from wavefront_tpu_torch.tools import (
    bench_ladder,
    event_lab,
    fused_ab,
    fusion_probe,
    gen_assets,
    gen_golden,
    gpu_parity,
    gpu_probe,
    occupancy,
    onehot_ab,
    parity_probe,
    prewarm,
    radix_lab,
    roofline,
    sort_sweep,
    stage_table,
    texel_lab,
    trace_tune,
)
from wavefront_tpu_torch.tools.kernel_times import radix_device, radix_keys
from wavefront_tpu_torch.tools._sweep import kernel_device_ms as device_ms
from wavefront_tpu_torch.tools._sweep import stage_times
from wavefront_tpu_torch.tools._timing import FILL_GROUPS, card, time_ms
from wavefront_tpu_torch.tools._timing import emit as emit_rows
from wavefront_tpu_torch.tools.event_lab import dda_steps
from wavefront_tpu_torch.utils.spans import device_events
from wavefront_tpu_torch.world import meshes
from wavefront_tpu_torch.world.blocks import BlockRegistry
from wavefront_tpu_torch.world.game_world import (
    EntityCreationData,
    EntityPhysicsData,
    GameWorld,
    Mesh,
    WorldSetBlock,
    translation,
)
from wavefront_tpu_torch.world.input import Event

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden", "config1_256.npz")

# H100 SXM: the device memory rate of NVIDIA's data sheet, and the rate at
# which the card issues operations that are not fused: one per lane and
# clock, 132 SMs x 128 lanes x 1.98 GHz (event_lab's `issue` rows measure
# 3.3e13 a second).  The data sheet's 67 TFLOP/s of float32 counts a fused
# multiply-add as two operations; every kernel here is built with
# -fmad=false, so none of the operations counted below is fused, and that
# rate would make each bound 2x optimistic.  Integer operations issue at
# the same rate.
HBM_BYTES_PER_S = 3.35e12
UNFUSED_OPS_PER_S = 132 * 128 * 1.98e9

# operations per unit of work, tallied from the kernel sources (compares,
# selects, conversions, integer and float arithmetic, loads; no branches
# or loop control):
# one fine crossing of the tracer: axis pick 5, the step, its range check
# and index move 3, the aux load 1, the face rule 6, the hit window 3, the
# march test 1, the stepped axis's crossing time 5, the skip test 1
TRACE_OPS_PER_FINE = 25
# one skip: radius 2, three cube exits 18, their minimum and the landing
# 3, the landing voxel 12, range and clip tests 4, flat index 4, the aux
# load 1, three crossing times 15, the skip test 1
TRACE_OPS_PER_SKIP = 60
# the shade of one live ray without NEE (hit point, face frame, uv,
# emission, scatter, hemisphere sample, branch merge, throughput fold)
SHADE_OPS_PER_RAY = 160
# NEE, once per NEE ray: one box importance (45) per live node with its
# share of the sibling sum, the divide, clamps, select and log (52); one
# add per path node; per prim its exp and the pick's running sums (5) and
# a plane/quad test in the pdf sweep (40); the picked prim's importance
SHADE_OPS_PER_NODE = 52
SHADE_OPS_PER_PICK_PRIM = 5
SHADE_OPS_PER_PDF_PRIM = 40
SHADE_OPS_PER_PICKED = 45
# the bf16 color build, beside that: 23 roundings of a color to bf16
# (3 reflectivity, cos_in, 9 in the emission, 3 lambertian reflectivity,
# the MIS weight, 3 radiance terms, 3 throughput factors), each a narrowing
# and a widening, and the throughput's 3 loads widened and 3 stores
# narrowed
SHADE_BF16_OPS_PER_RAY = 23 * 2 + 6
# the texel fetch of one ray: two multiplies and the float side of two
# saturating conversions and clamps
TEXEL_OPS_PER_RAY = 8
# the sparse NEE sweep (csrc/nee_sweep.cu): a ray's activity test, cosine,
# loads and stores (16); for every prim its plane test: the denominator
# and its test 7, the numerator 8, the numerator's sign 2; for a plane
# ahead within T_MAX the divide, its range test 3, the hit point 9, r1 and
# r2 10, u and v 8, the inside test 8; for each level of a kept crossing's
# reverse walk two box importances of 66 (12 corner offsets, 28 corner
# sums, tests and counts, 8 for the diagonal, 9 for the centre, 6 for the
# distance, 3 for the quotient) and the branch 5
NEE_OPS_PER_RAY = 16
NEE_OPS_PER_PLANE = 17
NEE_OPS_PER_AHEAD = 38
NEE_OPS_PER_LEVEL = 2 * 66 + 5

# the wrappers of the kernels a frame may launch, by name
FRAME_KERNELS = {"window_trace": window_trace, "shade": shade_pass,
                 "texel": texel_fetch, "ray_key": ray_key,
                 "ray_permute": ray_permute, "nee_sweep": nee_sweep}

TRACE_MISMATCH_FRACTION = 1e-5
SHADE_MAX_ABS = 1e-3
SHADE_RMS = 1e-5
# K2's bf16 build: bfloat16 values within this many bfloat16 ulps of the
# plain version's (see the module note)
SHADE_BF16_ULPS = 1


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def sync() -> None:
    torch.cuda.synchronize()


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


def trace_bound_ms(scene, n: int, fine: int, skips: int) -> tuple:
    """(bound_ms, bound_by) of the tracer: origin and direction in, pa, pb
    and t out, the grid and aux grid read once; or the operations of the
    steps the rays take (fine crossings and skips, from the plain
    version's march)."""
    nbytes = n * 36 + scene.grid.numel() + scene.aux_grid.numel()
    return max_bound(nbytes, fine * TRACE_OPS_PER_FINE
                     + skips * TRACE_OPS_PER_SKIP)


def shade_bound_ms(tables, n: int, n_alive: int, n_hit: int,
                   nee: bool, n_entity=None, bf16: bool = False) -> tuple:
    """(bound_ms, bound_by) of the shade: 16 words in and 12 out per ray
    (bf16: 100 bytes, the throughput 2 bytes a component each way), the
    atlas and light tables read once; or its float32 operations (bf16:
    and its conversions).  With the entity stream (n_entity: the lanes an
    entity wins) the flag word is read on every ray and the other 11
    words on those lanes."""
    stream = 0 if n_entity is None else n * 4 + n_entity * 44
    nbytes = (n * (100 if bf16 else 112) + stream + tables.atlas.numel() * 4
              + tables.nodes.numel() * 4 + tables.prims.numel() * 4)
    ops = n_alive * (SHADE_OPS_PER_RAY
                     + (SHADE_BF16_OPS_PER_RAY if bf16 else 0))
    if nee:
        # every hit ray counted as an NEE ray (mirror and glass hits take
        # none; the headline's are few)
        prims = len(tables.paths)
        ops += n_hit * ((tables.live - 1) * SHADE_OPS_PER_NODE
                        + sum(len(p) for p in tables.paths)
                        + prims * (SHADE_OPS_PER_PICK_PRIM
                                   + SHADE_OPS_PER_PDF_PRIM)
                        + SHADE_OPS_PER_PICKED)
    return max_bound(nbytes, ops)


def texel_bound_ms(atlas, n: int, nch: int) -> tuple:
    """(bound_ms, bound_by) of the texel fetch: tex, u and v in and nch
    floats out per ray, the atlas read once; or its float32 operations."""
    return max_bound(n * (12 + 4 * nch) + atlas.numel() * 4,
                     n * TEXEL_OPS_PER_RAY)


def max_bound(nbytes: int, ops: int) -> tuple:
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / UNFUSED_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def bf16_ulp(x):
    """The spacing of bfloat16 values at |x| (8 significant bits)."""
    _, e = torch.frexp(x.abs().double())
    return torch.ldexp(torch.ones_like(x, dtype=torch.float64), e - 8)


def shade_errors(got, want, rad, what: str) -> tuple:
    """K2's outputs against its plain version's on the same inputs (rad:
    the radiance in): (max |diff|, RMS) over every output, held under
    SHADE_MAX_ABS and SHADE_RMS; a bfloat16 tp (the bf16 build) is held
    within SHADE_BF16_ULPS bfloat16 ulps instead, and radiance within that
    many ulps of its bfloat16 term tp * emission (plus a float32 ulp)."""
    bf16 = want[2].x.dtype == torch.bfloat16
    s_max, s_rms = 0.0, 0.0
    for k, (kv, pv) in enumerate(zip(got, want)):
        for c, (kc, pc) in enumerate(zip(kv, pv)):
            check(kc.dtype == pc.dtype, f"{what}: output {k} is {kc.dtype}")
            check(bool(torch.isfinite(kc).all()), f"{what}: NaN/Inf")
            df = (kc.double() - pc.double()).abs()
            s_max = max(s_max, float(df.max()))
            s_rms = max(s_rms, float(df.pow(2).mean().sqrt()))
            if bf16 and k == 2:
                check(bool((df <= SHADE_BF16_ULPS * bf16_ulp(pc)).all()),
                      f"{what}: tp[{c}] off by {float(df.max())}")
            elif bf16 and k == 3:
                term = pc - rad[c]
                check(bool((df <= SHADE_BF16_ULPS * bf16_ulp(term)
                            + 1.2e-7 * pc.abs().clamp_min(1.0)).all()),
                      f"{what}: radiance[{c}] off by {float(df.max())}")
            else:
                check(float(df.max()) < SHADE_MAX_ABS
                      and float(df.pow(2).mean().sqrt()) < SHADE_RMS,
                      f"{what}: output {k}[{c}] max {float(df.max())}")
    return s_max, s_rms


def trace_check(arrays, o: V3, d: V3, events: int, what: str) -> dict:
    """K1 against its plain version on one set of rays, and against the
    plain version's unskipped march (the aux grid with its distances at
    0): the mismatch counts (each held under TRACE_MISMATCH_FRACTION), the
    largest |t| error on common hits, the plain version's words, and the
    steps: fine crossings and skips of the plain march, and the crossings
    of an unskipped one (`dda_crossings`)."""
    n = o.x.shape[0]
    pa, pb, t = window_trace(arrays, o, d, events)
    stats = {}
    qa, qb, qt = trace_plain(arrays, o, d, events, stats=stats)
    ua, ub, ut = trace_plain(
        arrays._replace(aux_grid=arrays.aux_grid & 3), o, d, events)
    sync()
    limit = TRACE_MISMATCH_FRACTION * n
    mism = {}
    for name, (ra, rb, rt) in (("skipped", (qa, qb, qt)),
                               ("unskipped", (ua, ub, ut))):
        mism[name] = {k: int((x != y).sum()) for k, x, y in
                      (("pa", pa, ra), ("pb", pb, rb), ("t", t, rt))}
        check(all(v <= limit for v in mism[name].values()),
              f"tracer {what}: mismatches {mism[name]} against the "
              f"{name} plain march, over {limit:.1f}")
    both = ((pa & 1) != 0) & ((qa & 1) != 0)
    t_err = float((t - qt)[both].abs().max()) if bool(both.any()) else 0.0
    trunc = int(((pa >> 22) & 1).sum())
    check(trunc == 0, f"tracer {what}: {trunc} rays truncated")
    alive = int(((d.x != 0) | (d.y != 0) | (d.z != 0)).sum())
    crossings = dda_steps(arrays, o, d, qa, qt)
    per_ray = stats.pop("per_ray")
    check(int(per_ray.sum()) == stats["fine"] + stats["skips"],
          f"tracer {what}: per-ray steps do not add up to the totals")
    steps = {**stats, "dda_crossings": crossings,
             "steps_per_live_ray": (stats["fine"] + stats["skips"])
             / max(alive, 1),
             "crossings_per_live_ray": crossings / max(alive, 1)}
    return {"mismatch": mism["skipped"],
            "mismatch_unskipped": mism["unskipped"], "max_abs_err_t": t_err,
            "plain": (qa, qb, qt), "steps": steps}


def kernel_check(scene, settings, basis) -> dict:
    """K1 and K2 against their plain versions on the card, on the
    headline's bounce-0 rays and on the bounce-1 rays the plain shade makes
    from them, each sorted by the coherence key as the renderer sorts;
    K2's bf16 color build too, on the same rays with tp in bfloat16."""
    arrays = scene.get_arrays()
    tables = prep_shade_tables(arrays.atlas_packed, arrays.lights)
    w, h = settings.render_width, settings.render_height
    n = w * h
    o, d, rid = raygen_soa(basis.eye, basis.front, basis.right, basis.up,
                           w, h, device="cuda")
    tp = V3(*(torch.ones(n, device="cuda") for _ in range(3)))
    rad = V3(*(torch.zeros(n, device="cuda") for _ in range(3)))
    events = auto_events(*arrays.grid.shape)
    out = {"rays": n, "bounces": [],
           "march_loop_instructions": event_lab.march_loop_instructions()}
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
        s_max, s_rms = shade_errors(got, want, rad, f"shade bounce {b}")
        # the bf16 build on the same rays, tp rounded to bfloat16
        args16 = args[:7] + (tp.map(lambda c: c.to(torch.bfloat16)),) \
            + args[8:]
        got16 = shade_pass(*args16, nee_type=1, color_bf16=True)
        want16 = shade_plain(*args16, nee_type=1, color_bf16=True)
        sync()
        b_max, b_rms = shade_errors(got16, want16, rad,
                                    f"shade bf16 bounce {b}")
        tp_equal = all(torch.equal(x, y) for x, y in zip(got16[2], want16[2]))

        alive = int(((d.x != 0) | (d.y != 0) | (d.z != 0)).sum())
        hits = int(((qa & 1) != 0).sum())
        rec = {
            "bounce": b, "alive": alive, "hits": hits, "steps": steps,
            "trace": {**tr,
                      "ms": time_ms(lambda: window_trace(arrays, o, d, events), 10),
                      "device_ms": device_ms(
                          lambda: window_trace(arrays, o, d, events),
                          "trace_kernel", 10),
                      "plain_ms": time_ms(lambda: trace_plain(arrays, o, d, events), 1)},
            "shade": {"max_abs_err": s_max, "rms": s_rms,
                      "ms": time_ms(lambda: shade_pass(*args, nee_type=1), 10),
                      "device_ms": device_ms(
                          lambda: shade_pass(*args, nee_type=1),
                          "shade_kernel", 10),
                      "plain_ms": time_ms(lambda: shade_plain(*args, nee_type=1), 1)},
            "shade_bf16": {
                "max_abs_err": b_max, "rms": b_rms, "tp_equal": tp_equal,
                "ms": time_ms(lambda: shade_pass(
                    *args16, nee_type=1, color_bf16=True), 10),
                "device_ms": device_ms(lambda: shade_pass(
                    *args16, nee_type=1, color_bf16=True), "shade_kernel", 10),
                "plain_ms": time_ms(lambda: shade_plain(
                    *args16, nee_type=1, color_bf16=True), 1)},
        }
        rec["trace"]["bound_ms"], rec["trace"]["bound_by"] = trace_bound_ms(
            arrays, n, steps["fine"], steps["skips"])
        rec["shade"]["bound_ms"], rec["shade"]["bound_by"] = shade_bound_ms(
            tables, n, alive, hits, True)
        rec["shade_bf16"]["bound_ms"], rec["shade_bf16"]["bound_by"] = \
            shade_bound_ms(tables, n, alive, hits, True, bf16=True)
        out["bounces"].append(rec)
        o, d, tp, rad = (V3(*(c.contiguous() for c in v)) for v in want)
    return out


def texel_check(scene, settings, basis, prefs) -> dict:
    """K3 against its plain version on the card: on the (tex, u, v) the
    general frame's first bounce hands it (miss lanes carry huge u, v), and
    on a seeded set of the same size with out-of-range slots, coordinates
    past both edges and non-finite lanes.  Times are of the first: through
    the wrapper by CUDA events (`ms`) and the kernel's own from
    torch.profiler (`device_ms`), beside PyTorch's indexed read.  Also
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
                 trace=trace_spy, texel=spy,
                 use_entities=bool(scene._entities))
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
    out["device_ms"] = device_ms(
        lambda: texel_fetch(atlas, tex, u, v, channels=chans),
        "texel_kernel", 20)
    out["library_device_ms"] = device_ms(
        lambda: atlas[texel_index(atlas, tex, u, v)][:, ch].t().contiguous(),
        "", 5)
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
    s_max, s_rms = shade_errors(got, want, rad, "shade with entities")
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
    general frame through the kernels against the plain versions, in
    float32 and with shade_bf16, and the headline scene with the ego cube
    on the fused path (K2 with the entity stream) against the general path
    (K3)."""
    def plain_frame(scene, settings, basis, prefs):
        img, aux = render_frame(
            scene.get_arrays(), basis.eye, basis.front, basis.right,
            basis.up, 1, settings=settings, nee_type=prefs.nee_type,
            sort_type=prefs.sort_type, trace=trace_plain, shade=shade_plain,
            texel=texel_plain, use_entities=bool(scene._entities))
        return img.cpu().numpy(), aux

    out = {"width": 480, "height": 270, "bounces": 4}
    scene, settings, basis, prefs = general_setup(480, 270, 4, device="cuda")
    for key, s in (("general_kernels_vs_plain", settings),
                   ("general_bf16_kernels_vs_plain",
                    settings.replace(shade_bf16=True))):
        got, aux = Renderer(s).render(scene, basis, prefs, frame_count=1,
                                      with_aux=True)
        want, aux_plain = plain_frame(scene, s, basis, prefs)
        check(aux == aux_plain == {"truncated": 0, "nee_overflow": 0},
              f"{key} 480x270 audit {aux} / {aux_plain}")
        out[key] = golden_gate(got, want, key)

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
    """The headline scene at 480x270, 4 bounces, through the kernels
    against the plain versions under the golden gate, in float32 and
    with shade_bf16 (K2's bf16 build)."""
    scene, settings, basis, prefs = headline_setup(480, 270, 4, device="cuda")
    out = {"width": 480, "height": 270, "bounces": 4}
    for key, s in (("float32", settings),
                   ("bf16", settings.replace(shade_bf16=True))):
        got = Renderer(s).render(scene, basis, prefs, frame_count=1)
        want, _ = render_frame(
            scene.get_arrays(), basis.eye, basis.front, basis.right,
            basis.up, 1, settings=s, nee_type=prefs.nee_type,
            sort_type=prefs.sort_type, trace=trace_plain, shade=shade_plain,
            use_entities=bool(scene._entities))
        gate = golden_gate(got, want.cpu().numpy(),
                           f"{key} frame kernels vs plain")
        if key == "float32":
            out.update(gate)
        else:
            out[key] = gate
    return out


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
                 texel=timed(texel_fetch, "texel"),
                 use_entities=bool(scene._entities))
    sync()
    return {k: [{"rays": m, "ms": a.elapsed_time(b)} for a, b, m in v]
            for k, v in events.items() if v}


def profile_frames(scene, settings, basis, prefs, frame_ms: float,
                   frames: int = 3) -> dict:
    """Where a frame's device time goes: `frames` frames under
    torch.profiler; device time per frame by PyTorch op (the two kernels'
    launches appear under their own names) and the device's idle share
    of the unprofiled frame time."""
    r = Renderer(settings)
    return profile_steps(
        lambda f: r.render(scene, basis, prefs, frame_count=100 + f,
                           as_numpy=False), frame_ms, frames)


def profile_steps(step, step_ms: float, steps: int = 3) -> dict:
    """`step(i)` for i < `steps` under torch.profiler: device busy ms a
    step, by PyTorch op (the kernels under their own names), the device
    events a step, and the idle share of `step_ms`, the unprofiled time
    of a step."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(steps):
            step(i)
        sync()
    dev = device_events(prof)
    busy_ms = sum(e.device_time for e in dev) / 1e3 / steps
    check(busy_ms > 0.0, "the profiler saw no device time")
    ours = {"window_trace": "trace_kernel", "shade": "shade_kernel",
            "texel": "texel_kernel"}
    by_op = {k: sum(e.device_time for e in dev if v in e.name) / 1e3 / steps
             for k, v in ours.items()}
    for row in prof.key_averages():
        t = row.self_device_time_total / 1e3 / steps
        if row.key.startswith("aten::") and t > 0.0:
            by_op[row.key] = t
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:12]
    return {"frames": steps, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / step_ms),
            "device_events_per_frame": len(dev) / steps,
            "device_ms_by_op": dict(top)}


def zero_launches() -> None:
    """Every frame kernel's launch counter to 0."""
    for fn in FRAME_KERNELS.values():
        fn.launches = 0


def read_launches() -> dict:
    return {k: fn.launches for k, fn in FRAME_KERNELS.items()}


def sort_launches(settings, sort_type: int, frames: int = 1,
                  cache_primary=None) -> dict:
    """The bounce sort's key and permute launches of `frames` frames: one
    of each a sorted bounce of `render_frame`'s schedule (compaction or
    sort_type 1; the bounces `sort_bounces` names; never bounce 0 under
    the primary cache, settings.cache_primary unless given), the key only
    under `trace_presort` (the morton key is built by tensor ops)."""
    if cache_primary is None:
        cache_primary = settings.cache_primary
    sorted_b = 0
    if settings.compaction or sort_type == 1:
        only = None if settings.sort_bounces is None else {
            int(i) for i in settings.sort_bounces}
        sorted_b = sum(1 for b in range(int(cache_primary),
                                        settings.num_bounces)
                       if only is None or b in only)
    n = sorted_b * frames
    return {"ray_key": n if settings.trace_presort else 0, "ray_permute": n}


def use_entities_path(name: str, limit: str, device: str = "cuda",
                      width: int = 1920, height: int = 1080) -> dict:
    """`render_frame(use_entities=...)` at full width on a scene with one
    live entity (the ego cube): the headline scene on the fused path (K1
    and K2) and the general scene on the general path (K1 and K3).  With
    False the frame equals bit for bit the frame of the same scene without
    the entity and runs no triangle sweep; with True it sweeps and
    differs.  Each frame's launches (the counters at 0 just before it) and
    triangle sweeps are reported."""
    sweep, swept = rr.triangle_sweep, []

    def counted(*a, **kw):
        swept.append(1)
        return sweep(*a, **kw)

    def frame(scene, settings, basis, prefs, use):
        zero_launches()
        swept.clear()
        img, aux = render_frame(
            scene.get_arrays(), basis.eye, basis.front, basis.right,
            basis.up, 1, settings=settings, nee_type=prefs.nee_type,
            sort_type=prefs.sort_type, use_entities=use)
        sync()
        check(aux == {"truncated": 0, "nee_overflow": 0}
              and bool(torch.isfinite(img).all()),
              f"use_entities={use}: audit {aux} or a non-finite pixel")
        return img, {"launches": read_launches(), "sweeps": len(swept)}

    out = {"card": name, "power_limit": limit, "width": width,
           "height": height, "bounces": 4}
    total = {k: 0 for k in FRAME_KERNELS}
    rr.triangle_sweep = counted
    try:
        for path, setup, kernels in (
                ("fused", headline_setup, ("shade",)),
                ("general", general_setup, ("texel", "nee_sweep"))):
            scene, settings, basis, prefs = setup(width, height, 4,
                                                  device=device)
            if path == "general":
                scene.remove_object("ego")
            free, f0 = frame(scene, settings, basis, prefs, False)
            add_ego_cube(scene, basis)
            off, f1 = frame(scene, settings, basis, prefs, False)
            on, f2 = frame(scene, settings, basis, prefs, True)
            want = {**{k: 4 if k == "window_trace" or k in kernels else 0
                       for k in FRAME_KERNELS},
                    **sort_launches(settings, prefs.sort_type,
                                    cache_primary=False)}
            check(device == "cpu"
                  or all(f["launches"] == want for f in (f0, f1, f2)),
                  f"use_entities {path}: launches {f0}, {f1}, {f2}")
            check(f1["sweeps"] == 0 and f2["sweeps"] == 4,
                  f"use_entities {path}: sweeps {f1}, {f2}")
            check(torch.equal(off, free), f"use_entities {path}: the False "
                  "frame differs from the entity-free frame")
            differ = int((on != free).any(dim=-1).sum())
            check(differ > 0, f"use_entities {path}: the True frame shows "
                  "no entity")
            out[path] = {"entity_free": f0, "false": f1, "true": f2,
                         "false_equals_entity_free": True,
                         "true_pixels_differing": differ}
            for f in (f0, f1, f2):
                for k, v in f["launches"].items():
                    total[k] += v
    finally:
        rr.triangle_sweep = sweep
    out["launches"] = total
    return out


def full_frame(what: str, scene, settings, basis, prefs, name: str,
               limit: str, kernels: tuple, frames: int) -> dict:
    """A main path at full size through `Renderer.render`: one frame with
    every launch counter at 0 just before it, which must launch each of
    `kernels` once per bounce, the sort's two kernels once a sorted bounce
    (`sort_launches`), and no other; then `frames` timed frames and one
    with CUDA events around each launch."""
    r = Renderer(settings)
    zero_launches()
    torch.cuda.reset_peak_memory_stats()
    img, aux = r.render(scene, basis, prefs, frame_count=0, as_numpy=False,
                        with_aux=True)
    sync()
    launches = read_launches()
    check(tuple(img.shape) == (settings.height, settings.width, 3),
          f"{what} image shape {tuple(img.shape)}")
    check(bool(torch.isfinite(img).all()), f"{what} image has NaN/Inf")
    mean = float(img.mean())
    check(mean > 0.0, f"{what} image mean {mean}")
    audit = {"truncated": 0, "nee_overflow": 0}
    check(aux == audit, f"{what} audit {aux}")
    nb = settings.num_bounces
    want = {**{k: nb if k in kernels else 0 for k in FRAME_KERNELS},
            **sort_launches(settings, prefs.sort_type)}
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


# integer operations per unit of work of the histogram and the probes,
# tallied from the kernel sources, set against the float32 rate above (the
# card's published table has no int32 rate; its int32 rate is lower, so
# the bound stays a lower bound):
# a key's digit (shift, mask) and its count
HIST_OPS_PER_KEY = 3
# beside a voxel's channel reads: the window test, the add into acc, the
# compare and select of the next cx and its modulo
EXTRACT_OPS_PER_ITER = 6
# the window form reads a voxel's 8 channel bytes as one 8-byte slot and
# folds them to one byte: an XOR of the two words, then two shifts and two
# XORs, the mask taken into the last
EXTRACT_WIN_FOLD_OPS = 5
# beside the column's sum: the low bit, the code update and its mask
LOOP_OPS_PER_ITER = 3
# a code's column of NR table bytes is summed four bytes an instruction
# (unsigned __dp4a): NR / 4 operations a lane-iteration
LOOP_BYTES_PER_OP = 4
# the card's shared memory serves one 128-byte row of its 32 banks a clock
# on each SM; a load of fewer than 4 bytes still takes a bank's slot
SMEM_BYTES_PER_S = 132 * 128 * 1.98e9


def smem_floor_ms(lane_iters: int, sass: dict, per_pass: int) -> float:
    """The least time the shared loads of `lane_iters` lane-iterations
    take: the loop's loads (`event_lab.probe_loop_sass`, a pass of the
    loop being `per_pass` lane-iterations) each counted as at least one
    4-byte bank slot, at SMEM_BYTES_PER_S."""
    return lane_iters * sass["shared_bank_bytes"] / per_pass \
        / SMEM_BYTES_PER_S * 1e3


def per_lane_iter(sass: dict, per_pass: int) -> dict:
    return {k: v / per_pass for k, v in sass.items()}


def exact(got, want, what: str) -> int:
    """Hold integer tensors equal; returns max |diff| (0)."""
    sync()
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)}")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
        if got.numel() else 0
    check(err == 0, f"{what}: max |diff| {err} against the plain version")
    return err


def radix_check(scene, settings, basis) -> dict:
    """K4 against its plain versions at the headline's ray count: on
    seeded keys and on the headline frame's own bounce-0 coherence keys
    (their low 32 bits), every shift, the one-read form and both forms of
    `radix_hist` (the spine).  Per call of one digit, of one read and of
    `radix_hist` (one read; and in four passes): ms (CUDA events, back to
    back), the device ms of every device operation the call makes
    (`device_ms_all*`) and their number (`device_ops*`), and the kernel's
    own device ms (`device_ms*`), by `kernel_times.radix_device`."""
    n = HEADLINE_RAYS
    keys_by_kind = radix_keys(scene, settings, basis)
    seeded = keys_by_kind["seeded"]
    check(keys_by_kind["frame"].shape[0] == n,
          f"the frame has {keys_by_kind['frame'].shape[0]} keys")
    out = {"keys": n, "max_abs_err": 0}

    def hold(got, want, what):
        out["max_abs_err"] = max(out["max_abs_err"], exact(got, want, what))

    for name, keys in keys_by_kind.items():
        for shift in (0, 8, 16, 24):
            got = rh.digit_histogram(keys, shift)
            hold(got, rh.hist_plain(keys, shift),
                 f"radix {name} shift {shift}")
            check(int(got.sum()) == n, f"radix {name} shift {shift}: the "
                  f"counts sum to {int(got.sum())}")
        four = rh.digit_histograms4(keys)
        hold(four, torch.stack([rh.hist_plain(keys, 8 * p)
                                for p in range(4)]), f"radix {name} one read")
        spine = rh.radix_hist_plain(keys)
        hold(rh.radix_hist(keys, one_read=True), spine,
             f"radix_hist {name} one read")
        hold(rh.radix_hist(keys), spine, f"radix_hist {name} four passes")
        out[f"distinct_digits_{name}"] = [int((row != 0).sum())
                                          for row in four]
        for call, fn in (
                ("", lambda: rh.digit_histogram(keys, 0)),
                ("_one_read", lambda: rh.digit_histograms4(keys)),
                ("_radix_hist", lambda: rh.radix_hist(keys, one_read=True)),
                ("_radix_hist_4pass", lambda: rh.radix_hist(keys))):
            out[f"ms{call}_{name}"] = time_ms(fn, 20)
            (out[f"device_ms_all{call}_{name}"],
             out[f"device_ops{call}_{name}"],
             out[f"device_ms{call}_{name}"]) = radix_device(fn, 20)
    ops = [out[f"device_ops{call}_{name}"]
           for call in ("", "_one_read", "_radix_hist")
           for name in ("seeded", "frame")]
    check(all(v is not None for v in ops), f"radix: the profiler lost "
          f"launches: {ops}")
    out["device_ops_per_call"] = max(ops)
    check(out["device_ops_per_call"] <= 2, f"radix: a call makes "
          f"{out['device_ops_per_call']} device operations")
    out["ms"] = out["ms_seeded"]
    out["device_ms"] = out["device_ms_all_seeded"]
    out["device_ms_one_read"] = out["device_ms_all_one_read_seeded"]
    out["plain_ms"] = time_ms(lambda: rh.hist_plain(seeded, 0), 5)
    out["library_ms"] = time_ms(lambda: torch.bincount(
        ((seeded.to(torch.int64) & 0xFFFFFFFF) >> 0) & 255, minlength=256), 5)
    out["library_device_ms"] = device_ms(lambda: torch.bincount(
        ((seeded.to(torch.int64) & 0xFFFFFFFF) >> 0) & 255, minlength=256),
        "", 5)
    digits = ((seeded.to(torch.int64) & 0xFFFFFFFF) & 255).contiguous()
    out["bincount_alone_ms"] = time_ms(
        lambda: torch.bincount(digits, minlength=256), 5)
    out["bound_ms"], out["bound_by"] = max_bound(
        4 * n + 4 * 256, n * HIST_OPS_PER_KEY)
    out["bound_ms_one_read"], out["bound_by_one_read"] = max_bound(
        4 * n + 4 * 4 * 256, n * 4 * HIST_OPS_PER_KEY)
    return out


def probe_check() -> dict:
    """K5, K6 and K7 against their plain versions on the card at small
    iteration counts, for one group and for more groups than the card has
    SMs, and K5's and K6's new designs at their edges; the shared memory a
    block is granted; and each kernel's time at a shape its lab gives it,
    beside the plain version's and the kernel's own device time
    (torch.profiler); for K5 and K6 also the machine code of a loop
    iteration (`event_lab.probe_loop_sass`) and the shared-memory floor it
    sets; for K7 torch.gather's device time and its launch path taken
    apart on the host clock (`gpu_probe.launch_split`)."""
    rng = np.random.default_rng(5)
    out = {"max_abs_err": {"device_probe": 0, "extract_probe": 0,
                           "loop_probe": 0}}
    err = out["max_abs_err"]

    def i32(a):
        return torch.as_tensor(np.ascontiguousarray(a).astype(np.int32),
                               device="cuda")

    def u8(shape):
        return torch.as_tensor(rng.integers(0, 255, shape).astype(np.uint8),
                               device="cuda")

    def worst(key, e):
        err[key] = max(err[key], e)

    # K6 and K5 at their lab shapes first: torch.profiler keeps device
    # events only for so many launches in a process, and the checks below
    # launch many small kernels of the plain versions
    groups, iters = FILL_GROUPS, 256
    tw = u8((25, 64, 128))
    cx, cz = roofline._lanes(rng, groups, 8, 160, 160, roofline.SPREAD)
    lanes = groups * 8 * 128
    # lab shapes: 8 rows of a group are 512 threads of 2 lanes
    win_sass = event_lab.probe_loop_sass("extract_probe",
                                         r"win_kernelILi2ELi8EE")
    cur_sass = event_lab.probe_loop_sass("extract_probe", r"cur_kernelILi2EE")
    ex = {"groups": groups, "rows": 8, "iters": iters, "windows": 25,
          "ms": time_ms(lambda: extract_probe.extract_win(
              tw, cx, cz, iters, 5, 5), 10),
          "plain_ms": time_ms(lambda: extract_probe.extract_win_plain(
              tw, cx, cz, iters, 5, 5), 1),
          "device_ms": device_ms(lambda: extract_probe.extract_win(
              tw, cx, cz, iters, 5, 5), "win_kernel", 10),
          # a pass of the window loop is 8 iterations of 2 lanes, its
          # stage included
          "smem_floor_ms": smem_floor_ms(lanes * iters, win_sass, 16),
          "sass_per_lane_iter": per_lane_iter(win_sass, 16)}
    ex["bound_ms"], ex["bound_by"] = max_bound(
        tw.numel() + 3 * 4 * lanes,
        lanes * iters * (EXTRACT_WIN_FOLD_OPS + EXTRACT_OPS_PER_ITER))
    table = u8((6, 160, 160))
    ux, uz = roofline._lanes(rng, groups, 8, 160, 160)
    cur = {"channels": 6, "table": [160, 160],
           "ms": time_ms(lambda: extract_probe.extract_cur(
               table, ux, uz, iters), 10),
           "device_ms": device_ms(lambda: extract_probe.extract_cur(
               table, ux, uz, iters), "cur_kernel", 10),
           "sass_per_lane_iter": per_lane_iter(cur_sass, 2)}
    cur["bound_ms"], cur["bound_by"] = max_bound(
        table.numel() + 3 * 4 * lanes,
        lanes * iters * (6 + EXTRACT_OPS_PER_ITER))
    ex["cur"] = cur
    out["extract_probe"] = ex

    out["support"] = event_lab.support()
    groups, iters = FILL_GROUPS, event_lab.ITERS["onehot64"][0]
    shape = (groups, 16, 128)
    state = (i32(rng.integers(0, 100, shape)),
             torch.zeros(shape, dtype=torch.int32, device="cuda"))
    table = u8((64, 128))
    lanes = groups * 16 * 128
    lo = {"variant": "onehot_smem", "table_rows": 64, "groups": groups,
          "rows": 16, "iters": iters,
          "ms": time_ms(lambda: loop_probe.loop_probe(
              "onehot_smem", state, table, iters), 10),
          "plain_ms": time_ms(lambda: loop_probe.loop_probe_plain(
              "onehot_smem", state, table, iters), 1),
          "device_ms": device_ms(lambda: loop_probe.loop_probe(
              "onehot_smem", state, table, iters), "loop_kernel", 10)}
    # 16 rows of a group are 512 threads of 4 lanes; a pass of the loop is
    # one iteration of each
    sass = event_lab.probe_loop_sass("loop_probe",
                                     r"loop_kernelILi1ELi64ELi4EE")
    lo["smem_floor_ms"] = smem_floor_ms(lanes * iters, sass, 4)
    lo["sass_per_lane_iter"] = per_lane_iter(sass, 4)
    lo["bound_ms"], lo["bound_by"] = max_bound(
        table.numel() + 4 * 4 * lanes,
        lanes * iters * (64 // LOOP_BYTES_PER_OP + LOOP_OPS_PER_ITER))
    table8 = u8((8, 128))
    sass8 = event_lab.probe_loop_sass("loop_probe",
                                      r"loop_kernelILi1ELi8ELi4EE")
    lo["table_rows_8"] = {
        "ms": time_ms(lambda: loop_probe.loop_probe(
            "onehot_smem", state, table8, iters), 10),
        "smem_floor_ms": smem_floor_ms(lanes * iters, sass8, 4),
        "sass_per_lane_iter": per_lane_iter(sass8, 4)}
    out["loop_probe"] = lo

    # K7
    x = torch.as_tensor(rng.random((512, 128), np.float32), device="cuda")
    got = device_probe.loop_add(x, 64)
    sync()
    check(torch.equal(got, device_probe.loop_add_plain(x, 64)),
          "loop_add differs from its plain version")
    ones = torch.ones((512, 128), device="cuda")
    check(torch.equal(device_probe.loop_add(ones, 4096), ones * 4096.0),
          "4096 adds of 1.0 are not 4096")
    for rows in (8, 512, 2048, 4096):
        t = i32(rng.integers(0, 100, (rows, 128)))
        i = i32(rng.integers(0, rows, (rows, 128)))
        for reps in (1, 64):
            worst("device_probe", exact(
                device_probe.row_gather_sum(t, i, reps),
                device_probe.row_gather_sum_plain(t, i, reps),
                f"row_gather_sum R={rows} reps={reps}"))
    out["smem_capacity"] = device_probe.smem_capacity()
    check(out["smem_capacity"]["max_bytes"] >= 48 * 1024,
          f"smem_capacity {out['smem_capacity']}")
    i64 = i.to(torch.int64)
    gather = {
        "rows": 4096, "reps": 1,
        "device_ms": device_ms(
            lambda: device_probe.row_gather_sum(t, i, 1),
            "row_gather_kernel", 20),
        "library_device_ms": device_ms(
            lambda: torch.gather(t, 0, i64), "", 20),
        "ms": time_ms(lambda: device_probe.row_gather_sum(t, i, 1), 50),
        "plain_ms": time_ms(
            lambda: device_probe.row_gather_sum_plain(t, i, 1), 20),
        # one gather along the row axis on int64 indices made beforehand
        "library_ms": time_ms(lambda: torch.gather(t, 0, i64), 50),
        "ms_reps64": time_ms(
            lambda: device_probe.row_gather_sum(t, i, 64), 20),
        "plain_ms_reps64": time_ms(
            lambda: device_probe.row_gather_sum_plain(t, i, 64), 5)}
    # after the profiled calls: the split launches 30,000 kernels more
    gather["host_split"] = gpu_probe.launch_split(t, i)
    gather["bound_ms"], gather["bound_by"] = max_bound(
        3 * 4 * t.numel(), t.numel())
    out["device_probe"] = gather

    # K6: lanes mostly in one window, some elsewhere, a few off the table
    nc, nwx, nwz = 7, 3, 2
    table = u8((nc, nwz * 32, nwx * 32))
    tw = extract_probe.tile_windows(table, nwx, nwz)
    for groups, rows in ((1, 8), (140, 8), (3, 16), (133, 32)):
        shape = (groups, rows, 128)
        stray = rng.random(shape) < 0.1
        cx = i32(np.where(stray, rng.integers(-3, nwx * 32 + 3, shape),
                          rng.integers(32, 64, shape)))
        cz = i32(np.where(stray, rng.integers(-3, nwz * 32 + 3, shape),
                          rng.integers(0, 32, shape)))
        for iters in (8, 24):
            worst("extract_probe", exact(
                extract_probe.extract_cur(table, cx, cz, iters),
                extract_probe.extract_cur_plain(table, cx, cz, iters),
                f"extract_cur {shape} iters={iters}"))
            worst("extract_probe", exact(
                extract_probe.extract_win(tw, cx, cz, iters, nwx, nwz),
                extract_probe.extract_win_plain(tw, cx, cz, iters, nwx, nwz),
                f"extract_win {shape} iters={iters}"))
    # the edges of the unrolled channel loop and the wrap: nc 1 to 16,
    # lanes that start 3 before the table and 2 past it, iteration counts
    # that are not a multiple of 8
    for nc in (1, 7, 8, 16):
        table = u8((nc, nwz * 32, nwx * 32))
        tw = extract_probe.tile_windows(table, nwx, nwz)
        for groups, rows in ((1, 1), (3, 8)):
            shape = (groups, rows, 128)
            edge = rng.random(shape)
            cx = i32(np.where(edge < 0.2, -3, np.where(
                edge > 0.8, nwx * 32 + 2, rng.integers(0, nwx * 32, shape))))
            cz = i32(np.where(edge > 0.9, nwz * 32 + 2,
                              rng.integers(0, nwz * 32, shape)))
            for iters in (1, 8, 40):
                worst("extract_probe", exact(
                    extract_probe.extract_cur(table, cx, cz, iters),
                    extract_probe.extract_cur_plain(table, cx, cz, iters),
                    f"extract_cur nc={nc} {shape} edges iters={iters}"))
                worst("extract_probe", exact(
                    extract_probe.extract_win(tw, cx, cz, iters, nwx, nwz),
                    extract_probe.extract_win_plain(tw, cx, cz, iters, nwx,
                                                    nwz),
                    f"extract_win nc={nc} {shape} edges iters={iters}"))
    # K5
    for variant in loop_probe.VARIANTS:
        body = variant.split("_")[0]
        extras = {"issue": [None], "onehot": [u8((64, 128)), u8((8, 128))],
                  "zsel": [torch.zeros((8, 8), dtype=torch.int32,
                                       device="cuda"),
                           i32(rng.integers(0, 255, (8, 8)))]}[body]
        for groups, rows in ((1, 8), (140, 16), (133, 32)):
            shape = (groups, rows, 128)
            state = (i32(rng.integers(-5, 133, shape)),)
            if body != "issue":
                state += (i32(rng.integers(0, 100, shape)),)
            for extra in extras:
                got = loop_probe.loop_probe(variant, state, extra, 19)
                want = loop_probe.loop_probe_plain(variant, state, extra, 19)
                for g, w in zip(got, want):
                    worst("loop_probe", exact(g, w, f"loop_probe {variant} "
                                              f"{shape}"))
    # the onehot forms' edges: every lane on one code, codes that share a
    # bank group (equal mod 16), codes outside [0, 128) (an empty one-hot;
    # the first iteration's & 127 brings them back), table bytes >= 128
    for variant in ("onehot_smem", "onehot_ldg", "onehot_const"):
        for nr in (64, 8):
            for case in ("one_code", "bank_group", "outside", "high_bytes"):
                for groups, rows in ((1, 1), (3, 16)):
                    shape = (groups, rows, 128)
                    code = {"one_code": np.full(shape, 77),
                            "bank_group": 16 * rng.integers(0, 8, shape) + 5,
                            "outside": rng.choice([-1, -128, 128, 1000, 3],
                                                  shape),
                            "high_bytes": rng.integers(0, 128, shape)}[case]
                    table = (torch.as_tensor(rng.integers(
                        128, 256, (nr, 128)).astype(np.uint8), device="cuda")
                        if case == "high_bytes" else u8((nr, 128)))
                    state = (i32(code), i32(rng.integers(0, 100, shape)))
                    for iters in (1, 5):
                        got = loop_probe.loop_probe(variant, state, table,
                                                    iters)
                        want = loop_probe.loop_probe_plain(variant, state,
                                                           table, iters)
                        for g, w in zip(got, want):
                            worst("loop_probe", exact(
                                g, w, f"loop_probe {variant} nr={nr} {case} "
                                f"{shape} iters={iters}"))
    return out


def probe_counters() -> dict:
    return {"radix_hist": (rh.digit_histogram, rh.digit_histograms4),
            "device_probe": (device_probe.loop_add,
                             device_probe.row_gather_sum,
                             device_probe.smem_copy),
            "extract_probe": (extract_probe.extract_cur,
                              extract_probe.extract_win),
            "loop_probe": (loop_probe.loop_probe, loop_probe.primitive)}


def labs() -> dict:
    """The four labs at full size, each row on a line of its own, with the
    launch counters of K4-K7 at 0 just before and read just after: every
    one of them must have launched."""
    counters = probe_counters()
    for fns in counters.values():
        for fn in fns:
            fn.launches = 0
    t0 = time.perf_counter()
    n_rows = len(emit_rows(
        {"lab": "radix_lab", **r} for r in radix_lab.rows()))
    n_rows += len(emit_rows(
        [{"lab": "gpu_probe", "row": "micro", **gpu_probe.micro_suite()}]))
    n_rows += len(emit_rows({"lab": "roofline", **r} for r in roofline.rows()))
    n_rows += len(emit_rows(
        {"lab": "event_lab", **r} for r in event_lab.rows()))
    sync()
    launches = {k: sum(fn.launches for fn in fns)
                for k, fns in counters.items()}
    check(all(v > 0 for v in launches.values()),
          f"labs: a kernel never launched: {launches}")
    return {"rows": n_rows, "launches": launches,
            "seconds": time.perf_counter() - t0}


def image_rel(scene, settings, settings16, basis, prefs) -> dict:
    """Frame 0 with shade_bf16 against the float32 frame 0, relative to
    1 + |pixel| (tests/test_shade_fused.py's unit): reported, not held to
    a bound (the bf16 frame is another rounding of the same estimator)."""
    a = Renderer(settings).render(scene, basis, prefs, frame_count=0,
                                  as_numpy=False)
    b = Renderer(settings16).render(scene, basis, prefs, frame_count=0,
                                    as_numpy=False)
    rel = (b - a).abs() / (1.0 + a.abs())
    return {"rel_max": float(rel.max()),
            "rel_rms": float(rel.pow(2).mean().sqrt()),
            "mean_float32": float(a.mean()), "mean_bf16": float(b.mean()),
            "pixels_equal": float((a == b).all(dim=-1).float().mean())}


def image_close(got, want, what: str) -> dict:
    """A cached frame against the uncached frame of its seed: max |diff|
    under 1e-3 and RMS under 1e-5 (0 is expected: no per-ray result
    depends on the order of the rays)."""
    diff = (got - want).abs()
    mx, rms = float(diff.max()), float(diff.pow(2).mean().sqrt())
    check(mx < 1e-3 and rms < 1e-5, f"{what}: max {mx} rms {rms}")
    return {"max_abs": mx, "rms": rms}


def batch(what: str, scene, settings, basis, prefs, kernels: tuple,
          k: int = 4, timed: int = 0, cache: bool = True) -> dict:
    """The batched-frame path: `render_batch(k)` as a stack and as a mean
    on a `cache_primary` renderer, with every frame counter at 0 just
    before the stack; held bit for bit against k `render` calls of a
    second such renderer, whose first frame fills the primary cache (the
    tracer launches on every bounce) and whose others reuse it (once
    less), the mean against their sum in frame order over k.  `timed`
    cached frames give `cached_frame_ms`.  `cache` False: the same
    without the primary cache, on the settings as given."""
    cached = settings.replace(cache_primary=True) if cache else settings
    nb = settings.num_bounces
    reset, read = zero_launches, read_launches

    def want(frames_filling, frames_cached):
        if not cache:
            frames_filling, frames_cached = frames_filling + frames_cached, 0
        frames = frames_filling + frames_cached
        return {**{name: 0 if name not in kernels else
                   (nb * frames - frames_cached if name == "window_trace"
                    else nb * frames) for name in FRAME_KERNELS},
                **sort_launches(cached, prefs.sort_type, frames)}

    single = Renderer(cached)
    singles, per_frame, trunc = [], [], 0
    for f in range(k):
        reset()
        img, aux = single.render(scene, basis, prefs, frame_count=f,
                                 as_numpy=False, with_aux=True)
        sync()
        per_frame.append(read())
        check(per_frame[-1] == want(int(f == 0), int(f > 0)),
              f"{what} single frame {f} launches {per_frame[-1]}")
        trunc += aux["truncated"] + aux["nee_overflow"]
        singles.append(img)
    singles = torch.stack(singles)

    r = Renderer(cached)
    reset()
    stack, aux = r.render_batch(scene, basis, prefs, frame_count=0, k=k,
                                as_numpy=False, with_aux=True)
    sync()
    launches = read()
    check(launches == want(1, k - 1), f"{what} batch launches {launches}")
    check(tuple(stack.shape) == (k, settings.height, settings.width, 3),
          f"{what} batch shape {tuple(stack.shape)}")
    check(bool(torch.isfinite(stack).all()), f"{what} batch has NaN/Inf")
    check(torch.equal(stack, singles),
          f"{what}: the batched frames differ from the single frames")
    trunc += aux["truncated"] + aux["nee_overflow"]

    reset()
    mean, aux = r.render_batch(scene, basis, prefs, frame_count=0, k=k,
                               accumulate=True, as_numpy=False, with_aux=True)
    sync()
    check(read() == want(0, k), f"{what} mean launches {read()}")
    total = singles[0]
    for img in singles[1:]:
        total = total + img
    mean_err = float((mean - singles.mean(dim=0)).abs().max())
    check(torch.equal(mean, total / float(k)),
          f"{what}: the accumulated mean differs from the single frames' "
          f"(max {mean_err} from their mean)")
    trunc += aux["truncated"] + aux["nee_overflow"]
    check(trunc == 0, f"{what}: {trunc} rays truncated or overflowed")

    out = {"width": settings.width, "height": settings.height, "bounces": nb,
           "k": k, "batch_equals_singles": True, "mean_equals_sum_over_k":
           True, "mean_max_abs_err": mean_err, "truncated": trunc,
           "launches": launches, "launches_filling_frame": per_frame[0]}
    if cache:
        uncached = Renderer(settings.replace(cache_primary=False)).render(
            scene, basis, prefs, frame_count=1, as_numpy=False)
        out["launches_cached_frame"] = per_frame[1]
        out["cached_vs_uncached"] = image_close(singles[1], uncached, what)
    if timed:
        sync()
        t0 = time.perf_counter()
        for f in range(timed):
            single.render(scene, basis, prefs, frame_count=k + f,
                          as_numpy=False)
        sync()
        out["cached_frame_ms"] = (time.perf_counter() - t0) * 1e3 / timed
        t0 = time.perf_counter()
        r.render_batch(scene, basis, prefs, frame_count=k, k=k,
                       accumulate=True, as_numpy=False)
        sync()
        out["batch_frame_ms"] = (time.perf_counter() - t0) * 1e3 / k
    return out


def hold_scene(scene, what: str, window=None) -> dict:
    """The scene's device grid and aux grid against its host grid and
    `make_aux_grid` of it, exactly; the host aux too; and, when given,
    `window` (a window assembled from scratch) against the host grid."""
    arrays = scene.get_arrays()
    grid = arrays.grid.cpu().numpy()
    aux = arrays.aux_grid.cpu().numpy()
    want = make_aux_grid(scene.grid, scene._transparent, scene._translucent)
    check(np.array_equal(grid, scene.grid),
          f"{what}: the device grid differs from the host grid")
    check(np.array_equal(scene._aux, want),
          f"{what}: the host aux grid differs from a fresh build")
    check(np.array_equal(aux, want),
          f"{what}: the device aux grid differs from a fresh build")
    if window is not None:
        check(np.array_equal(scene.grid, window),
              f"{what}: the grid differs from a window built from scratch")
    check(tuple(arrays.grid_origin) == tuple(scene.grid_origin),
          f"{what}: device origin {arrays.grid_origin}")
    return {"grid": list(grid.shape), "origin": list(scene.grid_origin),
            "grid_equal": True, "aux_equal": True,
            "window_equal": window is not None}


def hold_fresh(img, scene, settings, basis, prefs, frame: int,
               what: str) -> dict:
    """A frame of an edited or recentered scene against the same frame
    rendered by a new Renderer on a new VoxelScene built from the scene's
    host grid, origin and entities: equal bit for bit."""
    fresh = VoxelScene(scene.registry, scene.grid.copy(), scene.grid_origin,
                       max_light_prims=scene.max_light_prims,
                       max_entity_tris=scene.max_entity_tris,
                       device=scene.device)
    for key, (v, u, t, m) in scene._entities.items():
        fresh.add_object(key, v, u, t, transform=m)
    want = Renderer(settings).render(fresh, basis, prefs, frame_count=frame,
                                     as_numpy=False)
    sync()
    img = torch.as_tensor(img, device=want.device)
    check(torch.equal(img, want),
          f"{what}: the frame differs from the fresh scene's by "
          f"{float((img - want).abs().max())}")
    return {"fresh_scene_equal": True}


def edited_frames(what: str, scene, settings, basis, prefs, edit,
                  window=None, frames: int = 5) -> dict:
    """`frames` frames, each after one `edit(f)` and each synced (ladder
    configs 4 and 7), after a frame that settles the renderer, with the
    launch counters at 0 just before the first edit: the tracer and the
    fused shade once a bounce, every frame's audit, `edit_ms` (an edit,
    host to device) and `frame_ms`.  Then the scene is held
    (`hold_scene`, against `window()` when given), the last frame to a
    fresh scene's, and three more edited frames are profiled."""
    nb = settings.num_bounces
    r = Renderer(settings)
    r.render(scene, basis, prefs, frame_count=0, as_numpy=False)
    edit_ms, frame_ms = [], []
    zero_launches()
    for f in range(1, frames + 1):
        sync()
        t0 = time.perf_counter()
        edit(f)
        sync()
        t1 = time.perf_counter()
        img, aux = r.render(scene, basis, prefs, frame_count=f,
                            as_numpy=False, with_aux=True)
        sync()
        t2 = time.perf_counter()
        check(aux == {"truncated": 0, "nee_overflow": 0},
              f"{what} frame {f} audit {aux}")
        edit_ms.append((t1 - t0) * 1e3)
        frame_ms.append((t2 - t1) * 1e3)
    launches = read_launches()
    want = {"window_trace": nb * frames, "shade": nb * frames, "texel": 0,
            "nee_sweep": 0,
            **sort_launches(settings, prefs.sort_type, frames)}
    check(launches == want, f"{what} launches {launches}, want {want}")
    check(bool(torch.isfinite(img).all()) and float(img.mean()) > 0.0,
          f"{what}: image not finite or black")
    out = {"width": settings.width, "height": settings.height,
           "bounces": nb, "frames": frames, "launches": launches,
           "truncated": 0, "nee_overflow": 0,
           "edit_ms": float(np.mean(edit_ms)), "edit_ms_each": edit_ms,
           "frame_ms": float(np.mean(frame_ms)), "frame_ms_each": frame_ms,
           **hold_scene(scene, what, None if window is None else window()),
           **hold_fresh(img, scene, settings, basis, prefs, frames, what)}
    out["profile"] = profile_steps(
        lambda i: (edit(frames + 1 + i), r.render(
            scene, basis, prefs, frame_count=frames + 1 + i,
            as_numpy=False)), out["edit_ms"] + out["frame_ms"])
    return out


def edit_path(name: str, limit: str) -> dict:
    """Ladder config 4: the headline frame with one block edit before each
    of 5 frames, stone and air in turn at (8 + f % 16, 20, 3)."""
    scene, settings, basis, prefs = headline_setup(1920, 1080, 4,
                                                   device="cuda")
    reg = scene.registry
    stone = reg.block_idx("stone")

    def edit(f):
        scene.set_block((8 + f % 16, 20, 3), stone if f % 2 else reg.air)

    return {"card": name, "power_limit": limit,
            **edited_frames("edit", scene, settings, basis, prefs, edit)}


def streamed_path(name: str, limit: str, scene, cm, settings, basis,
                  prefs) -> dict:
    """Ladder config 6 (`streamed_setup(1920, 1080, 4)`: the 416x96x416
    window at load radius 6): the frame through `full_frame`, K1 against
    its plain version on its bounce-0 rays, a 480x270 frame through the
    kernels against the plain versions, the scene held against a window
    assembled from scratch and a frame against a fresh scene's."""
    t0 = time.perf_counter()
    lights = scene.get_arrays().lights
    sync()
    build_ms = (time.perf_counter() - t0) * 1e3
    out = full_frame("streamed", scene, settings, basis, prefs, name, limit,
                     ("window_trace", "shade"), frames=5)
    out["scene_build_ms"] = build_ms
    out["light_set"] = {"num_prims": lights.num_prims, "dense": lights.dense}
    out["profile"] = profile_frames(scene, settings, basis, prefs,
                                    out["frame_ms"])
    out["trace_check"] = streamed_trace_check(scene, settings, basis)
    out["frame_check"] = streamed_frame_check(scene, settings, basis, prefs)
    out.update(hold_scene(scene, "streamed", assembled(cm)))
    img = Renderer(settings).render(scene, basis, prefs, frame_count=6,
                                    as_numpy=False)
    out.update(hold_fresh(img, scene, settings, basis, prefs, 6, "streamed"))
    return out


def streamed_edit_path(name: str, limit: str, scene, cm, settings, basis,
                       prefs) -> dict:
    """Ladder config 7: the streamed window with one block edit a frame
    through the chunk manager, stone and air in turn at
    (8 + f % 16, 30, 3)."""
    reg = scene.registry
    stone = reg.block_idx("stone")

    def edit(f):
        cm.set_block((8 + f % 16, 30, 3), stone if f % 2 else reg.air)

    return {"card": name, "power_limit": limit, **edited_frames(
        "streamed_edit", scene, settings, basis, prefs, edit,
        lambda: assembled(cm))}


def assembled(cm) -> np.ndarray:
    """The chunk manager's window assembled from scratch from its chunks."""
    return cm._assemble(cm.chunks, cm.center_chunk, set())[0]


def streamed_trace_check(scene, settings, basis) -> dict:
    """K1 against its plain version on the streamed window's bounce-0 rays,
    sorted as the renderer sorts them (`trace_check`), with its time, its
    plain version's and its bound."""
    arrays = scene.get_arrays()
    dev = arrays.grid.device
    w, h = settings.render_width, settings.render_height
    n = w * h
    o, d, rid = raygen_soa(basis.eye, basis.front, basis.right, basis.up,
                           w, h, device=dev)
    tp = V3(*(torch.ones(n, device=dev) for _ in range(3)))
    rad = V3(*(torch.zeros(n, device=dev) for _ in range(3)))
    o, d, tp, rad, rid = coherence_sort(arrays, o, d, tp, rad, rid)
    events = auto_events(*arrays.grid.shape)
    tr = trace_check(arrays, o, d, events, "streamed bounce 0")
    tr.pop("plain")
    steps = tr.pop("steps")
    out = {"rays": n, "events": events, **tr, "steps": steps,
           "ms": time_ms(lambda: window_trace(arrays, o, d, events), 10),
           "plain_ms": time_ms(lambda: trace_plain(arrays, o, d, events), 1)}
    out["bound_ms"], out["bound_by"] = trace_bound_ms(
        arrays, n, steps["fine"], steps["skips"])
    return out


def streamed_frame_check(scene, settings, basis, prefs) -> dict:
    """The streamed window at 480x270, 4 bounces, through the kernels
    against the plain versions under the golden gate."""
    s = settings.replace(width=480, height=270)
    got = Renderer(s).render(scene, basis, prefs, frame_count=1)
    want, _ = render_frame(
        scene.get_arrays(), basis.eye, basis.front, basis.right, basis.up,
        1, settings=s, nee_type=prefs.nee_type, sort_type=prefs.sort_type,
        trace=trace_plain, shade=shade_plain,
        use_entities=bool(scene._entities))
    return {"width": 480, "height": 270,
            **golden_gate(got, want.cpu().numpy(),
                          "streamed frame kernels vs plain")}


def ray_sort_check(scene, settings, basis, prefs) -> dict:
    """The bounce sort's key and permute kernels (`kernels/ray_sort.py`)
    on the streamed window's four sorted bounces of a frame, as the
    renderer hands them their rays: each key equal to its plain version
    and the permutation equal to the 64-bit key's, each permute equal to
    the 13 gathers, bit for bit, and max |kernel - plain| over the
    bounces (`max_abs_err`).  Times of bounces 0 and 1 (CUDA events;
    device ms from torch.profiler), beside the plain versions, their byte
    bounds and `torch.sort` on both keys."""
    seen = []
    real = rr.coherence_sort

    def spy(arrays, o, d, tp, rad, rid, *riders, key=None):
        seen.append((arrays, o, d, [*o, *d, *tp, *rad, rid], key))
        return real(arrays, o, d, tp, rad, rid, *riders, key=key)

    rr.coherence_sort = spy
    try:
        Renderer(settings).render(scene, basis, prefs, frame_count=5)
    finally:
        rr.coherence_sort = real
    check(len(seen) == settings.num_bounces,
          f"a frame sorted {len(seen)} of {settings.num_bounces} bounces")
    out = {"bounces": [], "max_abs_err": {"ray_key": 0, "ray_permute": 0.0}}
    err = out["max_abs_err"]
    for b, (arrays, o, d, cols, key) in enumerate(seen):
        go, shape = arrays.grid_origin, arrays.grid.shape
        n = o.x.shape[0]
        got = ray_key(o, d, go, shape)
        plain = ray_key_plain(o, d, go, shape)
        wide = coherence_key(o.x - float(go[0]), o.y - float(go[1]),
                             o.z - float(go[2]), *d, *shape)
        check(torch.equal(got, key) and torch.equal(got, plain),
              f"ray_key bounce {b}: "
              f"{int((got != plain).sum())} keys differ from plain")
        perm = torch.sort(got, stable=True).indices
        check(torch.equal(perm, torch.sort(wide, stable=True).indices),
              f"ray_key bounce {b}: not the 64-bit key's permutation")
        err["ray_key"] = max(err["ray_key"], exact(got, plain, "ray_key"))
        moved = ray_permute(perm, cols)
        gathered = ray_permute_plain(perm, cols)
        check(all(torch.equal(m, g) for m, g in zip(moved, gathered)),
              f"ray_permute bounce {b}: differs from the gathers")
        err["ray_permute"] = max(err["ray_permute"], *(
            float((m.float() - g.float()).abs().max())
            for m, g in zip(moved, gathered)))
        row = {"bounce": b, "rays": n,
               "alive": int(((d.x != 0) | (d.y != 0) | (d.z != 0)).sum())}
        if b < 2:
            cols_bytes = sum(c.element_size() for c in cols)
            row["key"] = {
                "ms": time_ms(lambda: ray_key(o, d, go, shape), 20),
                "device_ms": device_ms(lambda: ray_key(o, d, go, shape),
                                       "ray_key_kernel", 20),
                "plain_ms": time_ms(lambda: ray_key_plain(o, d, go, shape),
                                    5),
                "bound_ms": max_bound(28 * n, 0)[0], "bound_by": "bytes"}
            row["permute"] = {
                "columns": len(cols),
                "ms": time_ms(lambda: ray_permute(perm, cols), 20),
                "device_ms": device_ms(lambda: ray_permute(perm, cols),
                                       "ray_permute_kernel", 20),
                "plain_ms": time_ms(lambda: ray_permute_plain(perm, cols),
                                    5),
                "bound_ms": max_bound((8 + 2 * cols_bytes) * n, 0)[0],
                "bound_by": "bytes"}
            row["sort_ms"] = {
                "int32": time_ms(lambda: torch.sort(got, stable=True), 10),
                "int64": time_ms(lambda: torch.sort(wide, stable=True), 10)}
        out["bounces"].append(row)
    return out


def recenter_path(name: str, limit: str) -> dict:
    """Ladder config 8 (`streamed_setup(1024, 1024, 6)`) and its recenter
    row (tools/bench_ladder.py): the centre moves one chunk along +x, the
    background rebuild runs while frames are served on the old window,
    then the adoption (`adopt_ms`: `update_grid`, host to device) and the
    first frame on the new window.  The recenter's launches, with the
    counters at 0 just before the rebuild starts, count the frames served
    and the adoption frame."""
    scene, cm, settings, basis, prefs = streamed_setup(1024, 1024, 6,
                                                       device="cuda")
    out = full_frame("streamed_1024x6", scene, settings, basis, prefs, name,
                     limit, ("window_trace", "shade"), frames=3)
    out["profile"] = profile_frames(scene, settings, basis, prefs,
                                    out["frame_ms"])
    r = Renderer(settings)
    r.render(scene, basis, prefs, frame_count=0, as_numpy=False)
    sync()
    origin0 = tuple(scene.grid_origin)
    cx, cy, cz = cm.center_chunk
    cm.center_chunk = (cx + 1, cy, cz)
    t0 = time.perf_counter()
    for key in cm._window_keys(cm.center_chunk):
        cm._request_chunk(key)
    gen_ms = (time.perf_counter() - t0) * 1e3
    cm._window_dirty = True
    cm._async_rebuild_opt = True
    audits, served = [], []
    zero_launches()
    t0 = time.perf_counter()
    cm._submit_rebuild()
    while not cm._rebuild_job.done():
        tf = time.perf_counter()
        _, aux = r.render(scene, basis, prefs, frame_count=90 + len(served),
                          as_numpy=False, with_aux=True)
        sync()
        served.append((time.perf_counter() - tf) * 1e3)
        audits.append(aux)
    ta = time.perf_counter()
    cm._adopt_rebuild()
    sync()
    tb = time.perf_counter()
    img, aux = r.render(scene, basis, prefs, frame_count=89, as_numpy=False,
                        with_aux=True)
    sync()
    tc = time.perf_counter()
    audits.append(aux)
    launches = read_launches()
    nb = settings.num_bounces
    frames = len(served) + 1
    want = {"window_trace": nb * frames, "shade": nb * frames, "texel": 0,
            "nee_sweep": 0,
            **sort_launches(settings, prefs.sort_type, frames)}
    check(launches == want, f"recenter launches {launches}, want {want}")
    check(all(a == {"truncated": 0, "nee_overflow": 0} for a in audits),
          f"recenter audits {audits}")
    check(tuple(scene.grid_origin) == (origin0[0] + 32, *origin0[1:]),
          f"recenter: origin {scene.grid_origin} from {origin0}")
    out.update(hold_scene(scene, "recenter", assembled(cm)))
    out.update(hold_fresh(img, scene, settings, basis, prefs, 89,
                          "recenter"))
    out["recenter"] = {
        "chunk_gen_ms": gen_ms, "launches": launches,
        "frames_served": len(served), "served_frame_ms": served,
        "rebuild_ms": (ta - t0) * 1e3, "adopt_ms": (tb - ta) * 1e3,
        "adopt_frame_ms": (tc - ta) * 1e3, "total_ms": (tc - t0) * 1e3}
    return out


def ego_spot(world, reg) -> np.ndarray:
    """Where to put the game's ego for its mouse ray, inside chunk
    (0, 0, 0): the first column (x, *, z), z then x from (8, *, 0), whose
    highest solid below y = 29 has 8 voxels of air above it and from 1.5
    above which the camera's centre ray meets a block within the ray's
    reach (the terrain is 3-D noise, so a fixed spot may sit inside it)."""
    q, cam = world.chunk_querier, world.camera
    solid = np.asarray(reg.solid, bool)
    for z, x in ((z, x) for z in range(32) for x in range(8, 32)):
        for y in range(28, -3, -1):
            ids = q.get_blocks(np.array([(x, y + k, z) for k in range(9)]))
            s = (ids >= 0) & solid[np.clip(ids, 0, len(solid) - 1)]
            if s[0] and not s[1:].any():
                pos = np.array([x + 0.5, y + 2.5, z + 0.5])
                cam.set_root_position(pos)
                basis = cam.eye_front_right_up()
                if q.trace_to_solid(basis.eye, basis.front, 10.0):
                    return pos
                break
    raise AssertionError("game: no spot where the mouse ray meets a block")


def game_path(name: str, limit: str) -> dict:
    """The game layer at the reference's scale: `GameWorld` with the
    load-radius window (13x3x13 chunks of 32^3), 1920x1080, 4 bounces,
    NEE on, a dynamic ego cube; one loading step, then 10 `step()` calls
    with the launch counters at 0 just before them: a `WorldSetBlock`
    (step 2), a block broken through the mouse ray (asked in step 4,
    applied in step 5; the ego is moved where that ray meets a block in
    step 3), and the ego moved across a chunk border (step 7), which
    recenters the window.  Chunks are generated on the calling
    thread and the window rebuilt there, so the run is the same every
    time (the background rebuild is `recenter_path`'s)."""
    reg = BlockRegistry.load(os.path.join(HERE, "assets"))
    settings = RenderSettings(width=1920, height=1080, num_bounces=4,
                              max_trace_steps=192, trace_audit=True,
                              compaction=True)
    world = GameWorld(reg, settings=settings, window_chunks=None,
                      headless=False)
    cm, pm, ego = world.managers[0], world.managers[1], world.managers[2]
    cm.synchronous = True
    world.camera.set_rendering_preferences(RenderingPreferences(nee_type=1))
    world.camera.pitch = -0.8
    verts, uv, tex = meshes.unitcube()
    lo, hi = meshes.mesh_aabb(verts)
    world.add_entity(0, EntityCreationData(
        mesh=Mesh(verts, uv, tex), isometry=translation(8.0, 6.0, 0.5),
        physics=EntityPhysicsData(
            rigid_body_type="dynamic", half_extents=(hi - lo) / 2,
            linvel=np.zeros(3), angvel=np.zeros(3), controlled=True)))
    # the step's render with its audit kept, and its block edits timed
    audits, edits = [], []
    render, set_block = world.renderer.render, world.scene.set_block

    def audited(*a, **kw):
        img, aux = render(*a, **kw, with_aux=True)
        audits.append(aux)
        return img

    def timed_set_block(*a, **kw):
        sync()
        t0 = time.perf_counter()
        set_block(*a, **kw)
        sync()
        edits.append((time.perf_counter() - t0) * 1e3)

    world.renderer.render = audited
    world.scene.set_block = timed_set_block

    t0 = time.perf_counter()
    world.step()
    load_ms = (time.perf_counter() - t0) * 1e3
    origin0 = tuple(world.scene.grid_origin)
    stone = reg.block_idx("stone")
    placed = (5, 20, 5)
    target = None
    steps_ms = []
    zero_launches()
    for i in range(1, 11):
        if i == 2:
            world.changes_since_last_step.append(
                WorldSetBlock(np.array(placed), stone))
        if i == 3:
            spot = ego_spot(world, reg)
            world.entities[0].isometry = translation(*spot)
            pm.bodies[0].pos = spot
            pm.bodies[0].linvel[:] = 0.0
        if i == 4:
            # the ego manager's mouse ray at the screen centre this step:
            # the camera's front from the pose the ego holds now
            cam = world.camera
            cam.set_root_position(world.entities[0].isometry[:, 3])
            basis = cam.eye_front_right_up()
            hit = world.chunk_querier.trace_to_solid(basis.eye, basis.front,
                                                     10.0)
            check(hit is not None,
                  f"game: the mouse ray from {basis.eye} hits no block")
            target = hit[0]
            ego.last_broke -= 1.0
            world.handle_window_event(Event(
                "mouse_move", x=settings.width / 2, y=settings.height / 2))
            world.handle_window_event(Event("mouse_down", button="left"))
        if i == 5:
            world.handle_window_event(Event("mouse_up", button="left"))
        if i == 7:
            world.entities[0].isometry = translation(40.5, 6.0, 0.5)
            pm.bodies[0].pos = np.array([40.5, 6.0, 0.5])
            pm.bodies[0].linvel[:] = 0.0
        t0 = time.perf_counter()
        world.step()
        steps_ms.append((time.perf_counter() - t0) * 1e3)
    launches = read_launches()
    nb = settings.num_bounces
    sort_type = world.camera.rendering_preferences().sort_type
    want = {"window_trace": nb * 10, "shade": nb * 10, "texel": 0,
            "nee_sweep": 0, **sort_launches(settings, sort_type, 10)}
    check(launches == want, f"game launches {launches}, want {want}")
    check(len(audits) == 11 and all(
        a == {"truncated": 0, "nee_overflow": 0} for a in audits),
          f"game audits {audits}")
    check(world.chunk_querier.get_block(np.array(placed)) == stone
          and world.scene.get_block(placed) == stone,
          "game: the WorldSetBlock did not land")
    check(world.chunk_querier.get_block(np.array(target)) == reg.air
          and world.scene.get_block(target) == reg.air,
          f"game: the block {target} under the mouse ray was not broken")
    check(tuple(world.scene.grid_origin) == (origin0[0] + 32, *origin0[1:]),
          f"game: the window did not recenter: {world.scene.grid_origin}")
    check(len(edits) == 2, f"game: {len(edits)} scene edits, want 2")
    img = world.last_image
    check(img.shape == (settings.height, settings.width, 3)
          and bool(np.all(np.isfinite(img))) and float(img.mean()) > 0.0,
          "game: the last image is not finite or black")
    out = {"card": name, "power_limit": limit, "width": settings.width,
           "height": settings.height, "bounces": nb, "steps": 10,
           "launches": launches, "truncated": 0, "nee_overflow": 0,
           "load_step_ms": load_ms, "steps_ms": steps_ms,
           "step_ms": float(np.median(steps_ms)),
           "recenter_step_ms": steps_ms[6], "edit_ms": float(np.mean(edits)),
           "edit_ms_each": edits, "broken": list(target),
           "placed": list(placed), "chunks": len(cm.chunks),
           **hold_scene(world.scene, "game", assembled(cm))}
    out.update(hold_fresh(img, world.scene, settings,
                          world.camera.eye_front_right_up(),
                          world.camera.rendering_preferences(),
                          world.frame_count - 1, "game"))
    out["profile"] = profile_steps(lambda i: world.step(), out["step_ms"])
    return out


# ---- the last modules: the app and its viewer, checkpoints, pixel
# ranges, the sort utilities, the validation layer, the device trace and
# the native chunk generator ----


def app_run(argv, prepare=None) -> tuple:
    """`app.main.main(argv)` with its world captured as tests/test_app.py
    captures it (`prepare(world)` runs on it before the loop) and each
    step timed on the host clock (a rendered step ends in the image's
    copy to the host), with the frame kernels' launches of the step and
    whether it rendered other scene arrays than the step before.
    Returns (world, its parsed args, the steps)."""
    import wavefront_tpu_torch.app.main as app

    build = app.build_world
    held, steps = {}, []

    def capture(args):
        world = build(args)
        if prepare is not None:
            prepare(world)
        step = world.step

        def timed_step():
            before = read_launches()
            t0 = time.perf_counter()
            step()
            ms = (time.perf_counter() - t0) * 1e3
            after = read_launches()
            arrays = world.scene.get_arrays()
            steps.append({"ms": ms, "arrays_changed":
                          held.get("arrays") is not arrays,
                          "launches": {k: after[k] - before[k]
                                       for k in after}})
            held["arrays"] = arrays

        world.step = timed_step
        held["world"], held["args"] = world, args
        return world

    app.build_world = capture
    try:
        app.main(argv)
    finally:
        app.build_world = build
    return held["world"], held["args"], steps


def app_path(name: str, limit: str, tmp: str, extra=()) -> tuple:
    """The app at its defaults (1024x1024, 6 bounces, 192 steps,
    `--window-chunks 2`, the scripted fly-through, chunks streamed by the
    worker pool and the background rebuild) for 20 frames with a
    screenshot every 10, the launch counters at 0 just before it; then 8
    frames of `--accumulate --hold` in a new world whose chunks load on the
    frame thread.  `extra`: flags added
    to both runs (a CPU rehearsal's `--device cpu` and sizes).  Returns
    (the phase's fields, the first run's world and args)."""
    from wavefront_tpu_torch.render.renderer import use_fused
    from wavefront_tpu_torch.render.screenshot import read_png
    from wavefront_tpu_torch.world.worldgen import native_chunk

    shots = os.path.join(tmp, "screenshots")
    frames = 20
    zero_launches()
    native0 = native_chunk.launches
    world, args, steps = app_run(
        ["--frames", str(frames), "--screenshot-every", "10", *extra],
        prepare=lambda w: setattr(w, "screenshot_dir", shots))
    launches = read_launches()
    settings, cm = world.settings, world.managers[0]
    nb = settings.num_bounces
    arrays = world.scene.get_arrays()
    prefs = world.camera.rendering_preferences()
    sorts = sort_launches(settings, prefs.sort_type)
    kinds = []
    for s in steps:
        per = s["launches"]
        check({k: per[k] for k in sorts} == sorts,
              f"app: a step launched {per}, want the sort's {sorts}")
        # the general shade runs the sparse NEE sweep a bounce on a
        # sparse light set, none on a dense one
        kind = ("fused" if per["shade"] == nb
                and per["texel"] == per["nee_sweep"] == 0 else
                "general" if per["texel"] == nb and per["shade"] == 0
                and per["nee_sweep"] in (0, nb) else f"other {per}")
        check(per["window_trace"] == nb and not kind.startswith("other"),
              f"app: a step launched {per}, want K1 {nb} and K2 or K3 {nb}")
        kinds.append(kind)
    check(len(steps) == frames, f"app: {len(steps)} steps, want {frames}")
    img = world.last_image
    check(img.shape == (settings.height, settings.width, 3)
          and bool(np.all(np.isfinite(img))) and float(img.mean()) > 0.0,
          f"app: the last image {img.shape} is not finite or black")
    files = sorted(os.listdir(shots))
    check(files == ["0.png", "1.png"], f"app: screenshots {files}")
    for f in files:
        with open(os.path.join(shots, f), "rb") as fh:
            shape = read_png(fh.read()).shape
        check(shape == (settings.height, settings.width, 3),
              f"app: screenshot {f} is {shape}")
    audited = Renderer(settings.replace(trace_audit=True),
                       device=world.scene.device)
    _, aux = audited.render(world.scene, world.camera.eye_front_right_up(),
                            prefs, frame_count=world.frame_count,
                            with_aux=True)
    check(aux == {"truncated": 0, "nee_overflow": 0}, f"app: audit {aux}")
    step_ms = [s["ms"] for s in steps]
    out = {
        "card": name, "power_limit": limit, "width": settings.width,
        "height": settings.height, "bounces": nb,
        "max_steps": settings.max_trace_steps, "frames": frames,
        "launches": launches, "paths": {k: kinds.count(k) for k in
                                        set(kinds)},
        "final_path": "fused" if use_fused(arrays, settings,
                                           prefs.nee_type) else "general",
        "truncated": 0, "nee_overflow": 0,
        "first_step_ms": step_ms[0],
        "step_ms": float(np.median(step_ms[1:])), "steps_ms": step_ms,
        "screenshots": files, "native_chunks": native_chunk.launches
        - native0, "chunks": len(cm.chunks),
        "window_rebuilds_in_flight": int(cm._rebuild_job is not None),
        "arrays_changed_steps": sum(s["arrays_changed"] for s in steps),
        "light_set": {"num_prims": arrays.lights.num_prims,
                      "dense": arrays.lights.dense},
    }
    check(out["native_chunks"] > 0, "app: no chunk came from the native "
          "generator")
    out["profile"] = profile_steps(lambda i: world.step(), out["step_ms"])
    # every call of one frame of the app world's final scene: 1024x1024
    # rays over 6 bounces, the window grid, the ego cube's entity stream
    out["kernel_check"] = frame_kernel_check(
        "app", world.scene, world.settings, world.camera.eye_front_right_up(),
        world.camera.rendering_preferences(), world.frame_count)

    # accumulation while the camera holds, its chunks generated on the
    # frame thread (as `game`), so the first step loads the whole window:
    # every later frame renders the same arrays and reuses the first
    # frame's primary hits, one K1 launch fewer
    acc_world, _, acc = app_run(
        ["--frames", "8", "--accumulate", "--hold", *extra],
        prepare=lambda w: setattr(w.managers[0], "synchronous", True))
    ks = []
    for i, s in enumerate(acc):
        reuse = i > 0 and not s["arrays_changed"]
        ks.append(s["launches"]["window_trace"])
        check(ks[-1] == nb - int(reuse),
              f"accumulate: step {i} launched K1 {ks[-1]} times "
              f"(arrays changed: {s['arrays_changed']})")
    reused = sum(k == nb - 1 for k in ks)
    check(reused == 7, f"accumulate: {reused} of the 7 frames after the "
          f"first reused the primary hits ({ks})")
    img = acc_world.last_image
    check(bool(np.all(np.isfinite(img))) and float(img.mean()) > 0.0,
          "accumulate: the image is not finite or black")
    out["accumulate"] = {
        "frames": 8, "k1_launches_by_step": ks, "frames_reusing": reused,
        "steps_ms": [s["ms"] for s in acc],
        "step_ms": float(np.median([s["ms"] for s in acc][1:]))}
    return out, world, args


def frame_kernel_check(what: str, scene, settings, basis, prefs,
                       frame_count: int, renderer=None) -> dict:
    """K1 and K2 (K3 on the general path) against their plain versions on
    every call of one frame, with the inputs the frame loop hands them:
    the compaction buckets, the scene's own `auto_events` budget, the
    entity stream.  Each K1 call is held by `trace_check` (the skipped and
    the unskipped plain march), each K2 call by `shade_errors` against
    `shade_plain`, each K3 call exactly against `texel_plain`; each K1
    and K2 call is timed on its inputs (CUDA events, 10 launches after a
    warm-up) beside its plain version's one call and its bound.
    `renderer`: the renderer whose primary cache the frame reads and
    fills (a new one by default); a frame it serves from the cache has no
    bounce-0 K1 call."""
    r = renderer or Renderer(settings, device=scene.device)
    arrays, kw, pkey, primary = r._frame_args(scene, basis, prefs)
    trace, shade, texel = [], [], []

    def once_ms(fn):
        """(fn(), its ms by CUDA events): one call, already warm."""
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn()
        e1.record()
        sync()
        return out, e0.elapsed_time(e1)

    def trace_spy(scene, o, d, events):
        n = int(o.x.shape[0])
        tr = trace_check(scene, o, d, events, f"{what} K1 call {len(trace)}")
        del tr["plain"]
        steps = tr.pop("steps")
        out = window_trace(scene, o, d, events)
        ms = time_ms(lambda: window_trace(scene, o, d, events), 10)
        _, plain_ms = once_ms(lambda: trace_plain(scene, o, d, events))
        bound, by = trace_bound_ms(scene, n, steps["fine"], steps["skips"])
        trace.append({"rays": n, "events": events, **tr,
                      "steps_per_live_ray": steps["steps_per_live_ray"],
                      "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                      "bound_by": by})
        return out

    def shade_spy(*args, **skw):
        n = int(args[2].x.shape[0])
        got = shade_pass(*args, **skw)
        ms = time_ms(lambda: shade_pass(*args, **skw), 10)
        want, plain_ms = once_ms(lambda: shade_plain(*args, **skw))
        s_max, s_rms = shade_errors(got, want, args[8],
                                    f"{what} K2 call {len(shade)}")
        tri = skw.get("tri_attrs")
        n_entity = None if tri is None else int(((tri[11] >> 16) & 1).sum())
        alive = int(((args[3].x != 0) | (args[3].y != 0)
                     | (args[3].z != 0)).sum())
        hits = int(((args[4] & 1) != 0).sum())
        bound, by = shade_bound_ms(args[0], n, alive, hits,
                                   skw["nee_type"] != 0, n_entity,
                                   skw.get("color_bf16", False))
        shade.append({"rays": n, "nee_type": skw["nee_type"],
                      "max_abs_err": s_max, "rms": s_rms,
                      "entity_hits": n_entity or 0, "ms": ms,
                      "plain_ms": plain_ms, "bound_ms": bound,
                      "bound_by": by})
        return got

    def texel_spy(atlas, tex, u, v, channels=None):
        got = texel_fetch(atlas, tex, u, v, channels=channels)
        err = float((got - texel_plain(atlas, tex, u, v, channels=channels)
                     ).abs().max())
        check(err == 0.0, f"{what} K3 call {len(texel)}: max |diff| {err}")
        texel.append({"rays": int(tex.shape[0]), "max_abs_err": err})
        return got

    img, aux = render_frame(arrays, basis.eye, basis.front, basis.right,
                            basis.up, frame_count, primary, **kw,
                            trace=trace_spy, shade=shade_spy, texel=texel_spy)
    r._keep_primary(arrays, pkey, primary, aux)
    nb = settings.num_bounces
    cached = primary is not None
    check(len(trace) == nb - cached and len(shade) + len(texel) == nb,
          f"{what} check: {len(trace)} K1, {len(shade)} K2 and "
          f"{len(texel)} K3 calls for {nb} bounces (cached: {cached})")
    check(bool(torch.isfinite(img).all()), f"{what} check: the frame is not "
          "finite")
    return {"frame_count": frame_count, "cached": cached,
            "grid": list(arrays.grid.shape), "trace": trace, "shade": shade,
            "texel": texel, "max_abs_err": {
                "window_trace": max((t["max_abs_err_t"] for t in trace),
                                    default=None),
                "shade": max((c["max_abs_err"] for c in shade), default=None),
                "texel": max((c["max_abs_err"] for c in texel),
                             default=None)}}


def viewer_path(name: str, limit: str, img: np.ndarray) -> dict:
    """The app's last frame through the viewer: its sRGB bytes and their
    JPEG encode at the viewer's quality 85 timed (5 times; the decoded
    image's 16x16 block means held to the frame's at a PSNR of at least
    35 dB; their mean |diff| and the pixels' reported), beside the PNG
    encode that screenshots take (zlib level 1, 5
    times, and level 6, 3 times), `publish`, then over loopback a first
    request (`GET /stats`), three `GET /frame` (image/jpeg, equal to
    `_encode()`'s bytes: the first encodes the frame, the others are
    served its bytes) and a `POST /input` batch that `drain_events`
    returns.  A loopback connection the machine refuses is reported, not
    held (the CPU test holds the round trip)."""
    import io
    import socket
    import threading
    import urllib.request

    from PIL import Image

    from wavefront_tpu_torch.app.viewer import Viewer
    from wavefront_tpu_torch.render.screenshot import (
        png_bytes,
        read_png,
        to_srgb_bytes,
    )

    def timed(fn, reps):
        ms = []
        for _ in range(reps):
            t0 = time.perf_counter()
            got = fn()
            ms.append((time.perf_counter() - t0) * 1e3)
        return got, ms

    def jpeg():
        buf = io.BytesIO()
        Image.fromarray(rgb, "RGB").save(buf, "JPEG", quality=85)
        return buf.getvalue()

    def fidelity(a, b, k):
        """(mean |diff| in levels, PSNR in dB) of the k x k block means."""
        h, w = (a.shape[0] // k) * k, (a.shape[1] // k) * k

        def means(x):
            return x[:h, :w].reshape(h // k, k, w // k, k, 3).mean((1, 3))

        d = means(a) - means(b)
        return float(np.abs(d).mean()), float(10.0 * np.log10(
            255.0 ** 2 / max(float((d ** 2).mean()), 1e-12)))

    rgb, srgb_ms = timed(lambda: to_srgb_bytes(img), 5)
    jpg, encode_ms = timed(jpeg, 5)
    decoded = np.asarray(Image.open(io.BytesIO(jpg)).convert("RGB"),
                         np.float64)
    check(decoded.shape == rgb.shape, f"viewer: the JPEG decodes to "
          f"{decoded.shape}, the frame is {rgb.shape}")
    # a 1-sample frame's pixel noise is what JPEG drops (and clips, which
    # shifts a noisy block's mean by about 2 levels), so the decoded image
    # is held to the frame by the PSNR of its 16x16 block means (a JPEG
    # unit with its halved chroma); the mean |diff| and the pixels' own
    # numbers are reported
    pixel_diff, pixel_psnr = fidelity(decoded, rgb.astype(np.float64), 1)
    mean_diff, psnr = fidelity(decoded, rgb.astype(np.float64), 16)
    check(psnr >= 35.0, f"viewer: the JPEG's 16x16 block means are "
          f"{mean_diff} levels off on average, PSNR {psnr} dB")
    data, png_ms = timed(lambda: png_bytes(rgb, level=1), 5)
    data6, encode6_ms = timed(lambda: png_bytes(rgb, level=6), 3)
    check(np.array_equal(read_png(data), rgb)
          and np.array_equal(read_png(data6), rgb),
          "viewer: the PNG does not decode to the frame")
    out = {"card": name, "power_limit": limit, "image": list(img.shape),
           "srgb_ms": float(np.median(srgb_ms)), "quality": 85,
           "jpeg_bytes": len(jpg), "encode_ms": float(np.median(encode_ms)),
           "encode_ms_each": encode_ms,
           "jpeg_block16_mean_abs_diff": mean_diff,
           "jpeg_block16_psnr_db": psnr,
           "jpeg_pixel_mean_abs_diff": pixel_diff,
           "jpeg_pixel_psnr_db": pixel_psnr, "png_bytes": len(data),
           "png_encode_ms": float(np.median(png_ms)),
           "png_encode_ms_each": png_ms, "png_bytes_level6": len(data6),
           "png_encode_ms_level6": float(np.median(encode6_ms))}
    v = Viewer(port=0)
    try:
        t0 = time.perf_counter()
        v.publish(img)
        out["publish_ms"] = (time.perf_counter() - t0) * 1e3
        try:
            socket.create_connection(("127.0.0.1", v.port), timeout=10).close()
        except OSError as e:
            out["loopback"] = f"refused: {e!r}"
            return out
        base = f"http://127.0.0.1:{v.port}"
        # the first request pays the client's and the server's first use
        t0 = time.perf_counter()
        urllib.request.urlopen(base + "/stats", timeout=60).read()
        out["get_stats_ms"] = (time.perf_counter() - t0) * 1e3
        get_ms, cpu_ms = [], []
        for _ in range(3):
            t0, c0 = time.perf_counter(), time.process_time()
            r = urllib.request.urlopen(base + "/frame", timeout=60)
            body = r.read()
            get_ms.append((time.perf_counter() - t0) * 1e3)
            cpu_ms.append((time.process_time() - c0) * 1e3)
            check(r.headers["Content-Type"] == "image/jpeg"
                  and body == v._encode() == jpg,
                  "viewer: /frame is not the frame's JPEG")
        out["get_frame_ms"] = get_ms
        # the process's CPU time over each request, every thread's: the
        # app's chunk threads share the interpreter with the server
        out["get_frame_process_cpu_ms"] = cpu_ms
        out["threads"] = sorted(t.name for t in threading.enumerate())
        batch = [{"kind": "key_down", "key": "w"},
                 {"kind": "mouse_move", "x": 12.5, "y": 7.0},
                 {"kind": "wheel", "dy": 1.0}]
        t0 = time.perf_counter()
        r = urllib.request.urlopen(urllib.request.Request(
            base + "/input", data=json.dumps(batch).encode(),
            method="POST"), timeout=60)
        out["post_input_ms"] = (time.perf_counter() - t0) * 1e3
        evs = v.drain_events()
        check(r.status == 204 and [e.kind for e in evs] == [
            "key_down", "mouse_move", "wheel"] and evs[1].x == 12.5,
              f"viewer: /input gave {r.status}, events {evs}")
        out["loopback"] = "ok"
    finally:
        v.close()
    return out


def settle(world) -> None:
    """Finish the world's chunk loading on the frame thread: wait for the
    pool's chunks and the rebuild in flight, adopt them, and generate and
    rebuild synchronously from then on."""
    cm = world.managers[0]
    for f in list(cm._pending.values()):
        f.result()
    cm._drain_pending()
    cm.flush_rebuild()
    cm.synchronous = True
    cm._async_rebuild_opt = False


def persistence_path(name: str, limit: str, world, args, tmp: str) -> dict:
    """A checkpoint of the app's world: the fly-through's key released
    and the loading finished, two steps, a stone placed by a
    `WorldSetBlock` beside the ego, `save_world`; then a new world of the
    same arguments on the card, `load_world`, one step.  Holds its device
    grid and aux grid equal to the saved world's exactly, and a frame of
    each scene by `Renderer.render` at the saved world's pose and one
    frame count equal bit for bit."""
    import wavefront_tpu_torch.app.main as app
    from wavefront_tpu_torch.utils.persistence import load_world, save_world

    world.handle_window_event(Event("key_up", key="w"))
    settle(world)
    world.step()
    world.step()
    reg = world.registry
    stone = reg.block_idx("stone")
    spot = np.floor(world.entities[0].isometry[:, 3]).astype(np.int64) \
        + np.array([2, -1, 2])
    world.changes_since_last_step.append(WorldSetBlock(spot, stone))
    world.step()
    check(world.scene.get_block(tuple(spot)) == stone,
          f"persistence: the edit at {spot} did not land")
    path = os.path.join(tmp, "world.npz")
    t0 = time.perf_counter()
    save_world(world, path)
    save_ms = (time.perf_counter() - t0) * 1e3
    fresh = app.build_world(args)
    t0 = time.perf_counter()
    load_world(fresh, path)
    load_ms = (time.perf_counter() - t0) * 1e3
    fresh.managers[0].synchronous = True
    t0 = time.perf_counter()
    fresh.step()
    step_ms = (time.perf_counter() - t0) * 1e3
    a, b = world.scene.get_arrays(), fresh.scene.get_arrays()
    check(tuple(a.grid_origin) == tuple(b.grid_origin)
          and torch.equal(a.grid, b.grid)
          and torch.equal(a.aux_grid, b.aux_grid),
          "persistence: the loaded world's device grid or aux grid differs")
    check(fresh.scene.get_block(tuple(spot)) == stone,
          "persistence: the loaded world lost the edit")
    basis = world.camera.eye_front_right_up()
    prefs = world.camera.rendering_preferences()
    frames = [Renderer(world.settings, device=s.device).render(
        s, basis, prefs, frame_count=world.frame_count, as_numpy=False)
        for s in (world.scene, fresh.scene)]
    check(torch.equal(*frames), "persistence: the loaded scene's frame "
          "differs by "
          f"{float((frames[0] - frames[1]).abs().max())}")
    return {"card": name, "power_limit": limit, "edit": spot.tolist(),
            "file_bytes": os.path.getsize(path), "save_ms": save_ms,
            "load_ms": load_ms, "load_step_ms": step_ms,
            "edited_chunks": len(world.managers[0].edited),
            "grid": list(a.grid.shape), "grid_equal": True,
            "aux_equal": True, "frame_equal": True}


def distributed_path(name: str, limit: str, device: str = "cuda",
                     size=(1920, 1080)) -> dict:
    """The headline frame through `DistributedRenderer` over two pixel
    ranges on one card and over `make_mesh()` (every visible card): its
    `frame_ms` against `Renderer.render`'s (both with the image's copy
    to the host), device busy ms, the launches of one frame with the
    counters at 0 just before it (each range launches K1 and K2 once a
    bounce), each image against the single renderer's, and
    `render_batch(k=4)` over two ranges against four `render` calls."""
    from wavefront_tpu_torch.parallel.mesh import DistributedRenderer, make_mesh

    scene, settings, basis, prefs = headline_setup(*size, 4, device=device)
    nb = settings.num_bounces
    single = Renderer(settings, device=device)

    def frame_ms(render) -> float:
        render(90)
        sync()
        t0 = time.perf_counter()
        for f in range(5):
            render(91 + f)
        return (time.perf_counter() - t0) * 1e3 / 5

    want = single.render(scene, basis, prefs, frame_count=3)
    out = {"card": name, "power_limit": limit, "width": settings.width,
           "height": settings.height, "bounces": nb,
           "single_frame_ms": frame_ms(
               lambda f: single.render(scene, basis, prefs, frame_count=f))}
    meshes = {"two_ranges": make_mesh(devices=[device] * 2)}
    if device == "cuda":
        meshes["make_mesh"] = make_mesh()
    for key, mesh in meshes.items():
        dr = DistributedRenderer(settings, mesh)
        zero_launches()
        got = dr.render(scene, basis, prefs, frame_count=3)
        launches = read_launches()
        k = len(mesh)
        wl = {"window_trace": nb * k, "shade": nb * k, "texel": 0,
              "nee_sweep": 0,
              **sort_launches(settings, prefs.sort_type, k,
                              cache_primary=False)}
        check(launches == wl, f"{key}: launches {launches}, want {wl}")
        row = {"ranges": [list(r) for r in dr.ranges()],
               "devices": [str(d) for d in mesh], "launches": launches,
               "bit_equal": bool(np.array_equal(got, want))}
        if not row["bit_equal"]:
            row.update(golden_gate(got, want, f"{key} vs single"))
            check(row["max_abs"] <= 1e-5, f"{key}: max |diff| "
                  f"{row['max_abs']}")
        row["frame_ms"] = frame_ms(
            lambda f: dr.render(scene, basis, prefs, frame_count=f))
        row["profile"] = profile_steps(
            lambda i: dr.render(scene, basis, prefs, frame_count=100 + i),
            row["frame_ms"])
        out[key] = row
    out["launches"] = out["two_ranges"]["launches"]
    dr = DistributedRenderer(settings, meshes["two_ranges"])
    stack = dr.render_batch(scene, basis, prefs, frame_count=10, k=4)
    singles = np.stack([dr.render(scene, basis, prefs, frame_count=10 + i)
                        for i in range(4)])
    check(np.array_equal(stack, singles),
          "distributed: render_batch(k=4) differs from four render calls")
    out["batch_equal"] = True
    return out


def sort_path(name: str, limit: str, device: str = "cuda",
              n: int = HEADLINE_RAYS) -> dict:
    """The six sort utilities on `n` seeded uint32 keys (int64 on the
    card), each held exactly against numpy (a stable argsort, cumsum, a
    per-partition bincount) and timed (CUDA events, 10 calls)."""
    from wavefront_tpu_torch.kernels import sort

    rs = np.random.RandomState(0x5EED)
    keys_np = rs.randint(0, 2 ** 32, size=n, dtype=np.uint64).astype(
        np.uint32)
    keys = torch.as_tensor(keys_np.astype(np.int64), device=device)
    vals = torch.arange(n, dtype=torch.int32, device=device)
    small = torch.as_tensor((keys_np & 0xFF).astype(np.int32), device=device)
    order = np.argsort(keys_np, kind="stable")
    part = 1024
    digits = (keys_np >> 8) & 0xFF
    rows = np.arange(n) // part
    want_hist = np.bincount(rows * 256 + digits, minlength=(n // part) * 256
                            ).reshape(n // part, 256).astype(np.int32)
    inv = np.empty(n, np.int64)
    inv[order] = np.arange(n)
    perm = torch.as_tensor(order, device=device)
    small_np = (keys_np & 0xFF).astype(np.int32)
    calls = {
        "sort_keys": (lambda: sort.sort_keys(keys), np.sort(keys_np)),
        "sort_key_value": (lambda: sort.sort_key_value(keys, vals),
                           (keys_np[order], order.astype(np.int32))),
        "sort_permutation": (lambda: sort.sort_permutation(keys), order),
        "invert_permutation": (lambda: sort.invert_permutation(perm), inv),
        "exclusive_scan": (lambda: sort.exclusive_scan(small),
                           np.cumsum(small_np, dtype=np.int32) - small_np),
        "segmented_histogram": (lambda: sort.segmented_histogram(
            keys, part, 8, 8), want_hist),
    }
    out = {"card": name, "power_limit": limit, "keys": n, "ms": {}}
    for key, (fn, want) in calls.items():
        got = fn()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            check(np.array_equal(g.cpu().numpy().astype(np.int64),
                                 np.asarray(w).astype(np.int64)),
                  f"sort: {key} differs from numpy")
        out["ms"][key] = time_ms(fn, 10) if device == "cuda" else None
    return out


def nan_outcome(fn) -> str:
    """'passes', or 'raises: <message>' when `fn` raises
    FloatingPointError under the validation layer's NaN checks."""
    from wavefront_tpu_torch.utils.validation import validation_layer

    try:
        with validation_layer():
            fn()
    except FloatingPointError as e:
        return f"raises: {e}"
    return "passes"


def validation_path(name: str, limit: str, device: str = "cuda",
                    big=(1920, 1080), small=(480, 270)) -> dict:
    """The validation layer on the card, the launch counters at 0 just
    before it: a NaN planted in one atlas texel and fetched by K3 raises
    naming the texel kernel; a NaN made by a tensor op raises naming the
    op; `check_image` passes on the headline frame; a 480x270 headline
    frame under the NaN checks passes, as the port's 16x16 CPU frame does
    (tests/test_torch_utils.py), and how much the checks slow it."""
    from wavefront_tpu_torch.utils.validation import check_image

    zero_launches()
    scene, settings, basis, prefs = headline_setup(*small, 4, device=device)
    arrays = scene.get_arrays()
    atlas = arrays.atlas_packed.clone()
    atlas[5, 3, 7, 0] = float("nan")
    n = 4096
    tex = torch.full((n,), 5, dtype=torch.int32, device=device)
    tex[::2] = 4
    size = atlas.shape[1]
    u = torch.full((n,), 7.5 / size, device=device)
    v = torch.full((n,), 3.5 / size, device=device)
    texel = nan_outcome(lambda: texel_fetch(atlas, tex, u, v))
    check(texel == "raises: invalid value (nan) encountered in texel_fetch",
          f"validation: the NaN texel {texel}")
    clean = nan_outcome(lambda: texel_fetch(arrays.atlas_packed, tex, u, v))
    check(clean == "passes", f"validation: a clean fetch {clean}")
    op = nan_outcome(lambda: torch.zeros(8, device=device) / 0.0)
    check(op.startswith("raises: invalid value (nan) encountered in "
                        "aten.div"), f"validation: 0/0 {op}")
    hscene, hsettings, hbasis, hprefs = headline_setup(*big, 4,
                                                       device=device)
    img = Renderer(hsettings, device=device).render(hscene, hbasis, hprefs,
                                                    frame_count=1)
    check_image(img, "the headline frame")
    r = Renderer(settings, device=device)
    r.render(scene, basis, prefs, frame_count=1)
    times = {}
    for key, wrap in (("off", lambda fn: fn()), ("on", nan_outcome),
                      ("off_again", lambda fn: fn())):
        t0 = time.perf_counter()
        outcome = wrap(lambda: r.render(scene, basis, prefs, frame_count=2))
        times[key] = (time.perf_counter() - t0) * 1e3
        if key == "on":
            frame = outcome
    check(frame == "passes", f"validation: the {small} frame {frame}, the "
          "CPU test's 16x16 frame passes")
    off = min(times["off"], times["off_again"])
    return {"card": name, "power_limit": limit, "texel_nan": texel,
            "op_nan": op, "check_image": "passes",
            "frame": {"width": small[0], "height": small[1], "bounces": 4,
                      "outcome": frame, "ms_off": off, "ms_on": times["on"],
                      "slowdown": times["on"] / off},
            "launches": read_launches()}


def trace_counts(path: str) -> dict:
    """The frame kernels' events in a Chrome trace of `device_trace`,
    found by name; the launch calls (runtime and driver events) whose
    correlation id no kernel event carries, inside the trace's warm-up
    span and after it (the first 10 of those after it with their time
    from the window's start in ms and the innermost CPU op around them);
    and the least time from a launch call to its kernel's start (us;
    below 0 where the host's and the card's clocks disagree)."""
    from wavefront_tpu_torch.utils.profiling import WARMUP_SPAN

    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    calls = [e for e in events if e.get("cat") in ("cuda_runtime",
                                                   "cuda_driver")
             and "LaunchKernel" in e.get("name", "")]
    window = next(e for e in events if e.get("cat") == "Trace")
    ops = [e for e in events if e.get("cat") in ("cpu_op",
                                                 "user_annotation")]
    warm = [(e["ts"], e["ts"] + e["dur"]) for e in ops
            if e["name"] == WARMUP_SPAN]
    ids = {e.get("args", {}).get("correlation") for e in kernels}
    launched = {e["args"]["correlation"]: e["ts"] for e in calls
                if "correlation" in e.get("args", {})}
    lags = [e["ts"] - launched[c] for e in kernels
            if (c := e.get("args", {}).get("correlation")) in launched]

    def around(call):
        inside = [e for e in ops if e.get("tid") == call.get("tid")
                  and e["ts"] <= call["ts"] <= e["ts"] + e.get("dur", 0)]
        return min(inside, key=lambda e: e.get("dur", 0))["name"] \
            if inside else None

    lost = [e for e in calls
            if e.get("args", {}).get("correlation") not in ids]
    region = [e for e in lost
              if not any(lo <= e["ts"] <= hi for lo, hi in warm)]
    names = {"window_trace": "trace_kernel", "shade": "shade_kernel",
             "texel": "texel_kernel", "ray_key": "ray_key_kernel",
             "ray_permute": "ray_permute_kernel",
             "nee_sweep": "nee_sweep_kernel"}
    return {"kernel_events": {k: sum(1 for e in kernels if v in e["name"])
                              for k, v in names.items()},
            "launch_calls": len(calls), "warmup_spans": len(warm),
            "calls_without_kernel_warmup": len(lost) - len(region),
            "calls_without_kernel": len(region),
            "lost": [{"from_start_ms": (e["ts"] - window["ts"]) / 1e3,
                      "op": around(e)} for e in region[:10]],
            "launch_to_start_us_min": min(lags) if lags else None}


def profiling_path(name: str, limit: str, tmp: str, device: str = "cuda",
                   size=(1920, 1080), sessions: int = 5) -> dict:
    """`device_trace` around one headline frame, `sessions` times, late
    in the process after its many profiler sessions, the launch counters
    at 0 just before each: each Chrome trace is written, its K1 and K2
    kernel events, found by name, are as many as the counters' launches,
    and every launch call after the trace's warm-up has its kernel event
    (the records that torch.profiler drops at a session's start are
    counted in the warm-up), and `device_trace` itself warns of no lost
    record; then `FrameTimer` over 5 frames."""
    from wavefront_tpu_torch.utils.profiling import FrameTimer, device_trace

    scene, settings, basis, prefs = headline_setup(*size, 4, device=device)
    r = Renderer(settings, device=device)
    r.render(scene, basis, prefs, frame_count=1)
    runs = []
    for i in range(sessions):
        zero_launches()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with device_trace(os.path.join(tmp, "trace")) as log_dir:
                r.render(scene, basis, prefs, frame_count=2 + i)
        launches = read_launches()
        path = os.path.join(log_dir, "trace.json")
        check(os.path.exists(path), f"profiling: no trace at {path}")
        runs.append({"launches": launches, **trace_counts(path),
                     "lost_record_warnings": [
                         str(w.message) for w in caught
                         if "device_trace" in str(w.message)]})
    if device == "cuda":
        for i, run in enumerate(runs):
            check(run["kernel_events"] == run["launches"]
                  and run["launches"]["window_trace"] == 4
                  and run["calls_without_kernel"] == 0
                  and run["warmup_spans"] == 1
                  and run["lost_record_warnings"] == [],
                  f"profiling: session {i}: {run}")
    timer = FrameTimer(rays_per_frame=settings.n_rays)
    for f in range(5):
        with timer.frame():
            r.render(scene, basis, prefs, frame_count=3 + f)
    s = timer.stats
    return {"card": name, "power_limit": limit, "trace_bytes":
            os.path.getsize(path), "sessions": runs,
            "trace_kernel_events": runs[-1]["kernel_events"],
            "launches": runs[-1]["launches"], "frame_timer": {
                "frames": 5, "frame_ms": s.frame_ms, "fps": s.fps,
                "mrays_per_sec": s.mrays_per_sec}}


# the ladder's timed frames: the JAX tool's default 5 for configs 1, 2 and
# 5, which no other phase runs at their own sizes; 3 for the rest
LADDER_FRAMES = {1: 5, 2: 5, 3: 3, 4: 3, 5: 5, 6: 3, 7: 3, 8: 3}
# configs whose every K1 and K2 call of a frame is held to the plain
# versions: 1 and 2, the frame paths that run K2 at nee_type 0, and 5,
# 3,686,400 rays a bounce over 8 bounces
LADDER_HELD = (1, 2, 5)


def ladder_frames(config: int, scene, cm, settings, basis, prefs,
                  frame_ms: float) -> dict:
    """One frame of a ladder config with the trace audit on and the launch
    counters at 0 just before it: its image finite, nonzero and of the
    config's shape, no ray truncated or overflowed, K1 and K2 once a
    bounce and K3 never (with the primary cache a cached frame too, K1
    once less); then device busy ms and idle share of one frame of the
    row's loop (`bench_ladder.frame_step`: configs 4's and 7's edits,
    config 5's accumulation) under torch.profiler over 3, against the
    row's `frame_ms`."""
    r = Renderer(settings.replace(trace_audit=True))
    nb = settings.num_bounces
    out = {}
    for key, cached in (("launches_one_frame", False),
                        ("launches_cached_frame", True)):
        if cached and not settings.cache_primary:
            break
        zero_launches()
        img, aux = r.render(scene, basis, prefs, frame_count=int(cached),
                            as_numpy=False, with_aux=True)
        sync()
        got = read_launches()
        want = {"window_trace": nb - cached, "shade": nb, "texel": 0,
                "nee_sweep": 0, **sort_launches(settings, prefs.sort_type)}
        check(got == want, f"ladder config {config} {key}: {got}, want "
              f"{want}")
        audit = {k: aux[k] for k in ("truncated", "nee_overflow")}
        check(audit == {"truncated": 0, "nee_overflow": 0},
              f"ladder config {config}: audit {audit}")
        check(tuple(img.shape) == (settings.height, settings.width, 3)
              and bool(torch.isfinite(img).all()) and float(img.mean()) > 0,
              f"ladder config {config}: image {tuple(img.shape)}, mean "
              f"{float(img.mean())}")
        out[key] = got
        out["audit"] = audit
        out["image_mean"] = float(img.mean())
    r = Renderer(settings)
    step = bench_ladder.frame_step(
        config, scene, cm, r, basis, prefs,
        TemporalAccumulator() if config == 5 else None)
    step(99)
    prof = profile_steps(lambda i: step(100 + i), frame_ms)
    out.update({k: prof[k] for k in (
        "device_busy_ms", "device_idle_share", "device_events_per_frame",
        "device_ms_by_op")})

    def each(fn, frames=5):
        """Host ms of `fn(f)` for each of `frames` frames, each ended by
        a synchronize."""
        times = []
        for f in range(frames):
            sync()
            t0 = time.perf_counter()
            fn(110 + f)
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        return times

    # the row's loop and the render alone, a frame at a time
    out["step_ms_synced"] = each(step)
    out["render_ms_synced"] = each(lambda f: r.render(
        scene, basis, prefs, frame_count=f, as_numpy=False))
    return out


def ladder_path(name: str, limit: str) -> tuple:
    """The ported ladder (`wavefront_tpu_torch/tools/bench_ladder.py`),
    configs 1-8 at their own sizes.  Each config's row through
    `bench_ladder.row`, the launch counters at 0 just before it (K1 and K2
    must launch, K3 not, the sort's two kernels where the config sorts; no
    ray truncated or overflowed), printed on a
    line of its own with what this script adds: `ladder_frames`, the
    card; config 1's k=8 stack and config 5's k=8 accumulating batch
    against 8 single frames bit for bit (`batch`, config 1 without the
    primary cache, as its row runs); every K1 and K2 call of a frame of
    configs 1, 2 and 5 held to the plain versions (`frame_kernel_check`;
    config 5's frame that fills the primary cache and a cached one).
    Returns (the phase's summary, the rows' launches by kernel)."""
    registry = BlockRegistry.load(os.path.join(HERE, "assets"))
    kernels = ("window_trace", "shade")
    launches = {k: 0 for k in FRAME_KERNELS}
    rows, errs = {}, {k: [] for k in kernels}
    for config, frames in LADDER_FRAMES.items():
        t0 = time.perf_counter()
        scene, cm, settings, nee, basis = bench_ladder.build(config, registry,
                                                             "cuda")
        if basis is None:
            basis = bench_ladder.default_pose()
        prefs = RenderingPreferences(nee_type=nee)
        zero_launches()
        rec = bench_ladder.row(config, scene, settings, basis, prefs, cm=cm,
                               frames=frames, batch=8)
        sync()
        got = read_launches()
        sorts = sort_launches(settings, prefs.sort_type)
        check(got["window_trace"] > 0 and got["shade"] > 0
              and got["texel"] == got["nee_sweep"] == 0
              and all((got[k] > 0) == (v > 0) for k, v in sorts.items()),
              f"ladder config {config}: row launches {got}")
        check(rec.get("truncated_rays", 0) == 0
              and rec.get("nee_overflow_rays", 0) == 0,
              f"ladder config {config}: row {rec}")
        for k, v in got.items():
            launches[k] += v
        out = {"frames_timed": frames, "row_launches": got,
               **ladder_frames(config, scene, cm, settings, basis, prefs,
                               rec["frame_ms"])}
        if config in (1, 5):
            out["batch"] = batch(f"ladder config {config}", scene, settings,
                                 basis, prefs, kernels, k=8,
                                 cache=settings.cache_primary)
        if config in LADDER_HELD:
            r = Renderer(settings)
            out["kernel_check"] = [frame_kernel_check(
                f"ladder config {config}", scene, settings, basis, prefs, 1,
                r)]
            if settings.cache_primary:
                out["kernel_check"].append(frame_kernel_check(
                    f"ladder config {config} cached", scene, settings, basis,
                    prefs, 2, r))
            for kc in out["kernel_check"]:
                for k in kernels:
                    errs[k].append(kc["max_abs_err"][k])
        secs = time.perf_counter() - t0
        print(json.dumps({"phase": "ladder_row", **rec, **out, "card": name,
                          "power_limit": limit, "seconds": secs}),
              flush=True)
        rows[config] = {k: rec[k] for k in (
            "frame_ms", "mrays_per_sec", "compile_s")} | {
            k: out[k] for k in ("device_busy_ms", "device_idle_share")} | {
            "seconds": secs}
    summary = {"card": name, "power_limit": limit, "rows": rows,
               "launches": launches, "max_abs_err": {
                   k: max(v, default=None) for k, v in errs.items()}}
    return summary, launches


def sweeps_path(name: str, limit: str, device: str = "cuda",
                width: int = 1920, height: int = 1080) -> dict:
    """The sweep tools (`wavefront_tpu_torch/tools/`, the ports of
    tools/sort_sweep.py, stage_table.py, fused_ab.py, texel_lab.py,
    trace_tune.py, occupancy.py and fusion_probe.py) at full width: the
    headline at 1920x1080x4, occupancy's streamed workload over the
    416x96x416 window.  Each tool's rows are printed one JSON line each
    (`sweep_row`).  Held: every sort schedule's image within
    `sort_sweep.IMAGE_TOLERANCE` of the every-bounce sort's and no ray
    truncated; the `nosort` row's image within it of `full`'s and the
    `dda` row's (K1's unskipped march) under the golden gate of it;
    every texel_lab row max |diff| 0; no truncated ray in any trace_tune
    combination or occupancy workload.  The launch counters are read
    from 0 around the whole phase: K1-K3 and the sort's two kernels must
    launch, and the sparse NEE sweep must not (the headline's light set is
    dense) (on the card;
    `device` "cpu" and a small width rehearse the phase with the plain
    versions)."""
    scene, settings, basis, prefs = headline_setup(width, height, 4,
                                                   device=device)
    hl = (scene, settings, basis, prefs)
    seconds, rows, images = {}, {}, {}
    tools = {
        "sort_sweep": lambda: sort_sweep.sweep(*hl, frames=3),
        "stage_table": lambda: stage_table.table(*hl, frames=3,
                                                 images=images),
        "fused_ab": lambda: fused_ab.ab(*hl, frames=3),
        "texel_lab": lambda: texel_lab.lab(dev=device),
        "trace_tune": lambda: trace_tune.tune(*hl, frames=2),
        "occupancy": lambda: occupancy.survey(width, height, device,
                                              headline=(scene, basis)),
        "fusion_probe": lambda: fusion_probe.probe(*hl),
    }
    zero_launches()
    for tool, run in tools.items():
        t0 = time.perf_counter()
        got = run()
        if device != "cpu":
            sync()
        seconds[tool] = time.perf_counter() - t0
        rows[tool] = emit_rows([{"phase": "sweep_row", "tool": tool, **r}
                                for r in got], device)
    launches = read_launches()
    check(all((v > 0) == (k != "nee_sweep") for k, v in launches.items())
          or device == "cpu", f"sweeps: launches {launches}")
    for r in rows["sort_sweep"]:
        check(r["max_abs_diff"] <= sort_sweep.IMAGE_TOLERANCE
              and r["truncated"] == 0,
              f"sort_sweep {r['row']}: max |diff| {r['max_abs_diff']}, "
              f"truncated {r['truncated']}")
    by_row = {r["row"]: r for r in rows["stage_table"] if "row" in r}
    check(by_row["nosort"]["max_abs_diff"] <= sort_sweep.IMAGE_TOLERANCE,
          f"stage_table nosort: max |diff| {by_row['nosort']}")
    dda = golden_gate(images["dda"].cpu().numpy(),
                      images["full"].cpu().numpy(), "stage_table dda")
    for r in rows["texel_lab"]:
        check(r["max_abs_diff"] == 0.0,
              f"texel_lab {r['row']} n {r['n']}: max |diff| "
              f"{r['max_abs_diff']}")
    for r in rows["trace_tune"] + rows["occupancy"]:
        check(r.get("truncated", 0) == 0 and "error" not in r,
              f"sweeps: {r}")
    return {"card": name, "power_limit": limit, "launches": launches,
            "seconds_by_tool": seconds, "dda_vs_full": dda,
            "sort_sweep": {r["row"]: {k: r[k] for k in (
                "frame_ms", "device_busy_ms", "sort_gather_ms", "trace_ms",
                "shade_ms", "max_abs_diff")} for r in rows["sort_sweep"]},
            "stage_table": {k: {"frame_ms": v["frame_ms"],
                                "device_busy_ms": v["device_busy_ms"]}
                            for k, v in by_row.items()}}


def tools_path(name: str, limit: str, headline_frame_ms: float,
               device: str = "cuda", width: int = 1920, height: int = 1080,
               golden_rows=(0, gen_golden.HEIGHT)) -> dict:
    """The repository's last tools, ported (`wavefront_tpu_torch/bench.py`
    and `tools/`: gpu_parity, parity_probe, gen_golden, gen_assets,
    onehot_ab, prewarm, gpu_sweep), at full width: the headline at
    1920x1080x4.  Each tool's rows are printed one JSON line each
    (`tools_row`).  Held: the bench's audit frame with no ray truncated
    or overflowing; the golden gate (`gpu_parity`) and the bench gate
    (`gpu_parity --bench`: truncated 0, nee_overflow 0, the headline
    against the 512-step plain march); `parity_probe`'s `cache` with 0
    divergent pixels, `trace` with hit, face and the voxel of hit lanes
    off on at most 1e-5 of the rays (0 at 256x256), `split` under the
    golden gate (`nee` and `scatter` are reported, not held); the oracle's
    golden (`gen_golden`, into build/chip_smoke/) within 1e-6 relative of
    the stored one; the asset pack (`gen_assets`, into
    build/chip_smoke/assets) equal to assets/ (blocks.json byte for byte,
    every texture's RGBA); every K5 form equal to the indexed read
    (`onehot_ab`); every program of `prewarm` finite; `gpu_sweep --stages
    gates` run as a user runs it, every command with exit code 0.  The
    launch counters of the frame kernels and K5 are read from 0 around the
    in-process tools: each must launch (on the card; `device` "cpu", a
    small width and a band of `golden_rows` rehearse the phase with the
    plain versions)."""
    dev = torch.device(device)
    counters = {**FRAME_KERNELS, "loop_probe": loop_probe.loop_probe}
    for fn in counters.values():
        fn.launches = 0
    hl = headline_setup(width, height, 4, device=device)
    out_dir = os.path.join(HERE, "build", "chip_smoke")
    seconds = {}

    def run(tool: str, fn):
        t0 = time.perf_counter()
        got = fn()
        if device != "cpu":
            sync()
        seconds[tool] = time.perf_counter() - t0
        return got

    def show(tool: str, got: list) -> list:
        emit_rows([{"phase": "tools_row", "tool": tool, **r} for r in got],
                  device)
        return got

    rec, aux = run("bench", lambda: bench.measure(*hl, frames=10, k=5))
    show("bench", [{**rec, **aux}])
    check(aux["truncated"] == 0 and aux["nee_overflow"] == 0,
          f"bench: audit {aux}")
    gates = run("gpu_parity", lambda: [gpu_parity.golden_check(dev),
                                       gpu_parity.bench_gate(*hl)])
    for r in show("gpu_parity", gates):
        check(r["pass"], f"gpu_parity {r['check']}: {r}")
    probe = {}
    for cmd in parity_probe.CMDS:
        probe[cmd] = show(f"parity_probe {cmd}", run(
            f"parity_probe {cmd}", lambda: parity_probe.COMMANDS[cmd](dev)))
    for r in probe["cache"]:
        check(r["divergent"] == 0, f"parity_probe cache: {r}")
    tr = probe["trace"][0]
    for f in ("hit", "face", "vx_hitlanes", "vy_hitlanes", "vz_hitlanes"):
        check(tr[f] <= TRACE_MISMATCH_FRACTION * tr["n"],
              f"parity_probe trace: {f} differs on {tr[f]} of {tr['n']}")
    for r in probe["split"]:
        check(r.get("golden_gate", {"pass": True})["pass"],
              f"parity_probe split: {r}")
    gg = run("gen_golden", lambda: gen_golden.generate(
        os.path.join(out_dir, "gen_golden", "config1_256.npz"), golden_rows,
        os.cpu_count() or 1))
    show("gen_golden", [gg])
    check(gg["within_1e-6"], f"gen_golden: {gg}")
    root = os.path.join(out_dir, "assets")
    ga = run("gen_assets", lambda: {"root": os.path.relpath(root, HERE),
                                    **gen_assets.versions(),
                                    **gen_assets.compare(
                                        root, gen_assets.generate(root))})
    show("gen_assets", [ga])
    check(ga["pass"], f"gen_assets: {ga}")
    ab = show("onehot_ab", run("onehot_ab", lambda: onehot_ab.ab(
        *hl[:3], lanes=width * height)))
    for r in ab:
        check(r.get("max_abs_diff_vs_indexed", 0) == 0, f"onehot_ab: {r}")
    warm = show("prewarm", run("prewarm", lambda: prewarm.warm(*hl, k=5)))
    check(all(r.get("finite", True) for r in warm), f"prewarm: {warm}")
    launches = {k: fn.launches for k, fn in counters.items()}
    # every tool renders a dense light set: the sparse sweep never runs
    check(all((v > 0) == (k != "nee_sweep") for k, v in launches.items())
          or device == "cpu", f"tools: launches {launches}")
    cmd = [sys.executable, "-m", "wavefront_tpu_torch.tools.gpu_sweep",
           "--stages", "gates"]
    if device == "cpu":
        cmd += ["--device", "cpu", "--width", str(width), "--height",
                str(height)]
    sweep = run("gpu_sweep", lambda: subprocess.run(
        cmd, cwd=HERE, capture_output=True, text=True, timeout=600))
    stages = [json.loads(line) for line in sweep.stdout.splitlines()
              if line.startswith('{"stage"')]
    show("gpu_sweep", stages)
    check(sweep.returncode == 0 and len(stages) == 2
          and all(r["exit"] == 0 for r in stages),
          f"gpu_sweep --stages gates: exit {sweep.returncode}, {stages}, "
          f"{sweep.stderr[-2000:]}")
    by_form = {(r["form"], r["table_rows"]): r["ns_per_iter"]
               for r in ab if r["row"] == "k5"}
    return {"card": name, "power_limit": limit, "launches": launches,
            "seconds_by_tool": seconds,
            "bench": {k: rec[k] for k in ("value", "frame_ms",
                                          "vs_baseline")},
            "headline_frame_ms": headline_frame_ms,
            "gpu_parity": {r["check"]: {k: r[k] for k in (
                "frac_divergent_pixels", "rmse_rel_agreeing", "max_rel",
                "pass")} for r in gates},
            "bench_gate_audit": {k: gates[1][k] for k in (
                "truncated_rays", "nee_overflow_rays")},
            "parity_trace": tr,
            "parity_split": [r["golden_gate"] for r in probe["split"]
                             if "golden_gate" in r],
            "nee_mismatch": sum(r["mismatch"] for r in probe["nee"]),
            "scatter_mismatch": sum(r["mismatch"] for r in probe["scatter"]),
            "gen_golden": {k: gg[k] for k in ("rows", "procs", "seconds",
                                              "max_abs_diff",
                                              "differing_pixels")},
            "gen_assets": {k: ga[k] for k in ("pil", "zlib", "textures",
                                              "byte_equal_textures",
                                              "rgba_equal_textures",
                                              "blocks_json_byte_equal")},
            "k1_ms": {r["ray_set"]: r["ms"] for r in ab if r["row"] == "k1"},
            "k5_ns_per_iter": {f"{f}_{n}": v for (f, n), v in by_form.items()},
            "prewarm_s": {r["row"]: r["seconds"] for r in warm},
            "gpu_sweep": [r["exit"] for r in stages]}


def worldgen_path(name: str, limit: str) -> dict:
    """The headline scene's 5x1x5 chunks (32^3) from the native generator
    (`csrc/worldgen.cpp`, built by the host compiler) and from its NumPy
    version, held equal exactly and each timed; fails unless the native
    library was built and made every chunk."""
    from wavefront_tpu_torch.core.config import WorldSettings
    from wavefront_tpu_torch.world.worldgen import WorldGenerator, native_chunk

    gen = WorldGenerator(WorldSettings(),
                         BlockRegistry.load(os.path.join(HERE, "assets")))
    keys = [(cx, 0, cz) for cx in range(-2, 3) for cz in range(-2, 3)]
    before = native_chunk.launches
    t0 = time.perf_counter()
    native = [gen.generate_chunk(k) for k in keys]
    native_ms = (time.perf_counter() - t0) * 1e3
    made = native_chunk.launches - before
    t0 = time.perf_counter()
    plain = [gen._generate_chunk_numpy(k) for k in keys]
    numpy_ms = (time.perf_counter() - t0) * 1e3
    lib = _build._lib_path("worldgen", ".cpp", _build.HOST_FLAGS)
    check(made == len(keys) and os.path.exists(lib),
          f"worldgen: the native generator made {made} of {len(keys)} "
          f"chunks (library {lib})")
    check(all(np.array_equal(a, b) for a, b in zip(native, plain)),
          "worldgen: a native chunk differs from the NumPy one")
    return {"card": name, "power_limit": limit, "chunks": len(keys),
            "chunk_size": 32, "native_ms_per_chunk": native_ms / len(keys),
            "numpy_ms_per_chunk": numpy_ms / len(keys),
            "library": os.path.relpath(lib, HERE), "equal": True}


def nee_stats(lights, o: V3, d: V3, mis, max_depth: int):
    """What the sparse sweep's inputs ask of it, from the plain version's
    crossing test (`_prim_tile_hits`) in 64-prim tiles: each ray's
    crossings (0 for a ray with no MIS weight or no direction), the
    (ray, prim) pairs of live rays with the plane ahead within T_MAX, and
    the walk levels of every crossing (the depth of its prim's leaf, at
    most max_depth)."""
    live = (mis > 0) & ((d.x != 0) | (d.y != 0) | (d.z != 0))
    parent = lights.node_parent.cpu().numpy()
    depth = np.zeros(lights.p0.shape[0], np.int64)
    for j, leaf in enumerate(lights.leaf_node.cpu().numpy()[
            :lights.num_prims]):
        k = int(leaf)
        while depth[j] < max_depth and 0 <= parent[k] != 0xFFFFFFFF:
            k = int(parent[k])
            depth[j] += 1
    dev = o.x.device
    depth = torch.as_tensor(depth, device=dev)
    crossings = torch.zeros_like(mis, dtype=torch.int64)
    ahead = levels = 0
    chunk = 1 << 19
    for lo in range(0, mis.shape[0], chunk):
        rows = slice(lo, lo + chunk)
        co, cd, cl = o.map(lambda c: c[rows]), d.map(lambda c: c[rows]), \
            live[rows]
        for base in range(0, lights.num_prims, 64):
            pid = torch.arange(base, base + 64, device=dev)
            hit, t = _prim_tile_hits(lights, co, cd, cl, pid)
            ok = cl[:, None] & (pid < lights.num_prims)[None, :]
            ahead += int((ok & (t >= EPSILON_NEE) & (t <= T_MAX)).sum())
            crossings[rows] += hit.sum(1)
            levels += int((hit.sum(0) * depth[pid.clamp_max(
                lights.p0.shape[0] - 1)]).sum())
    return crossings, int(live.sum()), ahead, levels


def nee_sweep_check(scene, settings, basis, prefs) -> dict:
    """The sparse NEE sweep's kernel (`kernels/nee_sweep.py`) on the
    lamp-lit window's four bounces of a frame (`lamps_setup`: 1920x1080x4,
    476 prims), as the renderer hands them their rays: each pdf against
    its plain version's (`nee_sweep_plain`) on the same inputs within
    1e-6 relative a ray, and bit for bit on the rays with one crossing;
    the crossings and overflowing rays equal to the plain version's and
    to the crossing test's; one launch a call.  Times of bounces 0 and 1
    (CUDA events; device ms from torch.profiler) beside the plain
    version's and the operations bound of what the inputs ask
    (`nee_stats`)."""
    seen = []
    real = rr.nee_pdf_sweep

    def spy(lights, point, normal, direction, mis, dense_probs, **kw):
        seen.append((lights, point, normal, direction, mis))
        return real(lights, point, normal, direction, mis, dense_probs, **kw)

    rr.nee_pdf_sweep = spy
    try:
        Renderer(settings, device=scene.get_arrays().grid.device).render(
            scene, basis, prefs, frame_count=5)
    finally:
        rr.nee_pdf_sweep = real
    nb = settings.num_bounces
    check(len(seen) == nb, f"a frame swept {len(seen)} of {nb} bounces")
    depth, hits = settings.max_bvh_depth, settings.max_nee_hits
    out = {"num_prims": seen[0][0].num_prims, "max_nee_hits": hits,
           "bounces": [], "max_rel_err": 0.0}
    for b, (lights, o, nrm, d, mis) in enumerate(seen):
        args = (lights, o, nrm, d, mis, depth, hits)
        counts = torch.zeros(2, dtype=torch.int64, device=mis.device)
        before = nee_sweep.launches
        got = nee_sweep(*args, counts)
        check(nee_sweep.launches == before + 1,
              f"nee_sweep bounce {b}: {nee_sweep.launches - before} launches")
        plain_counts = torch.zeros_like(counts)
        want = nee_sweep_plain(*args, plain_counts)
        crossings, live, ahead, levels = nee_stats(lights, o, d, mis, depth)
        sync()
        got_c, want_c = counts.tolist(), plain_counts.tolist()
        stats_c = [int(crossings.sum()), int((crossings > hits).sum())]
        check(got_c == want_c == stats_c,
              f"nee_sweep bounce {b}: crossings and overflow {got_c}, plain "
              f"{want_c}, crossing test {stats_c}")
        check(bool(torch.isfinite(want).all()),
              f"nee_sweep bounce {b}: the plain pdf is not finite")
        rel = float(((got - want).abs()
                     / want.abs().clamp_min(1e-30)).max()) if want.numel() \
            else 0.0
        check(rel <= 1e-6, f"nee_sweep bounce {b}: relative error {rel}")
        one = crossings == 1
        check(torch.equal(got[one], want[one]),
              f"nee_sweep bounce {b}: a ray with one crossing differs")
        out["max_rel_err"] = max(out["max_rel_err"], rel)
        n = mis.shape[0]
        row = {"bounce": b, "rays": n, "live": live, "crossings": got_c[0],
               "overflow": got_c[1], "one_crossing_rays": int(one.sum()),
               "tests": live * lights.num_prims, "ahead": ahead,
               "walk_levels": levels}
        if b < 2:
            ops = (n * NEE_OPS_PER_RAY + row["tests"] * NEE_OPS_PER_PLANE
                   + ahead * NEE_OPS_PER_AHEAD + levels * NEE_OPS_PER_LEVEL)
            c = torch.zeros_like(counts)
            row.update({
                "ms": time_ms(lambda: nee_sweep(*args, c), 10),
                "device_ms": device_ms(lambda: nee_sweep(*args, c),
                                       "nee_sweep_kernel", 10),
                "plain_ms": time_ms(lambda: nee_sweep_plain(*args, c), 2),
                "bound_ms": max_bound(44 * n, ops)[0],
                "bound_by": max_bound(44 * n, ops)[1]})
        out["bounces"].append(row)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name, limit = card()
    t0 = time.perf_counter()
    seconds = {}

    def emit(phase: str, **fields) -> None:
        """The phase's line, with the seconds since the last one."""
        now = time.perf_counter()
        seconds[phase] = now - sum(seconds.values()) - t0
        print(json.dumps({"phase": phase, **fields,
                          "seconds": seconds[phase]}), flush=True)

    _build.build_all()
    ptxas = {k: _build.resource_usage(k) for k in (
        "window_trace", "shade", "texel", "extract_probe", "loop_probe")}
    emit("device", card=name, power_limit=limit,
         kind=torch.cuda.get_device_name(0), torch=torch.__version__,
         cuda=torch.version.cuda, build_s=time.perf_counter() - t0,
         ptxas=ptxas)
    # K3's unrolled channel loop keeps its loads in registers: a stack
    # frame or a spill would mean they went through local memory
    # so do K5's onehot forms (loop_kernel<1..3,...>) and K6's unrolled
    # channel loops; zsel_local keeps its array in local memory on purpose
    held = {"texel": ptxas["texel"],
            "extract_probe": ptxas["extract_probe"],
            "loop_probe": [k for k in ptxas["loop_probe"] if any(
                k["kernel"].startswith(f"loop_kernel<{v},")
                for v in (1, 2, 3))]}
    for src, kerns in held.items():
        check(len(kerns) > 0 and all(
            k.get("stack") == k.get("spill_stores") == k.get("spill_loads")
            == 0 for k in kerns), f"{src} kernels use local memory: {kerns}")

    # what the last modules write (a trace, screenshots, a checkpoint)
    out_dir = os.path.join(HERE, "build", "chip_smoke")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
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
    s16 = settings.replace(shade_bf16=True)
    hb = full_frame("headline_bf16", scene, s16, basis, prefs, name, limit,
                    ("window_trace", "shade"), frames=5)
    prof16 = profile_frames(scene, s16, basis, prefs, hb["frame_ms"])
    emit("headline_bf16", **hb, **{k: prof16[k] for k in (
        "device_busy_ms", "device_idle_share", "device_events_per_frame",
        "device_ms_by_op")}, uncached_float32_frame_ms=hl["frame_ms"],
         vs_float32=image_rel(scene, settings, s16, basis, prefs))
    lights = gen[0].get_arrays().lights
    gf = full_frame("general", *gen, name, limit,
                    ("window_trace", "texel", "nee_sweep"), frames=3)
    emit("general", **gf, max_nee_hits=gen[1].max_nee_hits, light_set={
        "num_prims": lights.num_prims, "prim_bucket": lights.p0.shape[0],
        "node_bucket": lights.node_min.shape[0], "dense": lights.dense})
    emit("general_profile", **profile_frames(*gen, gf["frame_ms"], frames=2),
         stages=stage_times(*gen, 10))
    ue = use_entities_path(name, limit)
    emit("use_entities", **ue)
    rc = radix_check(scene, settings, basis)
    emit("radix_check", **rc)
    pc = probe_check()
    emit("probe_check", **pc)
    lb = labs()
    emit("labs", **lb)
    bt = batch("batch", scene, settings, basis, prefs,
               ("window_trace", "shade"), timed=5)
    emit("batch", **bt, card=name, power_limit=limit,
         uncached_frame_ms=hl["frame_ms"])
    emit("batch_general", **batch(
        "batch_general", *general_setup(480, 270, 4, device="cuda"),
        ("window_trace", "texel", "nee_sweep")))
    paths = {"headline": hl, "headline_bf16": hb, "general": gf,
             "use_entities": ue, "batch": bt}
    paths["edit"] = edit_path(name, limit)
    emit("edit", **paths["edit"])
    streamed = streamed_setup(1920, 1080, 4, device="cuda")
    paths["streamed"] = streamed_path(name, limit, *streamed)
    emit("streamed", **paths["streamed"])
    rs = ray_sort_check(streamed[0], *streamed[2:])
    emit("ray_sort_check", **rs)
    lamps = lamps_setup(1920, 1080, 4, device="cuda")
    ns = nee_sweep_check(lamps[0], *lamps[2:])
    del lamps
    emit("nee_sweep_check", **ns)
    paths["streamed_edit"] = streamed_edit_path(name, limit, *streamed)
    emit("streamed_edit", **paths["streamed_edit"])
    paths["streamed_1024x6"] = recenter_path(name, limit)
    emit("streamed_1024x6", **paths["streamed_1024x6"])
    paths["game"] = game_path(name, limit)
    emit("game", **paths["game"])
    paths["app"], app_world, app_args = app_path(name, limit, out_dir)
    emit("app", **paths["app"])
    emit("viewer", **viewer_path(name, limit, app_world.last_image))
    emit("persistence", **persistence_path(name, limit, app_world, app_args,
                                           out_dir))
    paths["distributed"] = distributed_path(name, limit)
    emit("distributed", **paths["distributed"])
    emit("sort", **sort_path(name, limit))
    paths["validation"] = validation_path(name, limit)
    emit("validation", **paths["validation"])
    emit("profiling", **profiling_path(name, limit, out_dir))
    emit("worldgen", **worldgen_path(name, limit))
    lad, lad_launches = ladder_path(name, limit)
    paths["ladder"] = {"launches": lad_launches}
    emit("ladder", **lad)
    sw = sweeps_path(name, limit)
    paths["sweeps"] = {"launches": sw["launches"]}
    emit("sweeps", **sw)
    tl = tools_path(name, limit, hl["frame_ms"])
    paths["tools"] = {"launches": tl["launches"]}
    emit("tools", **tl)
    emit("seconds", total=time.perf_counter() - t0, by_phase=seconds)

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
            "launches_by_path": {p: v["launches"][kname]
                                 for p, v in paths.items()},
            "max_abs_err": k.get("max_abs_err_t", k.get("max_abs_err")),
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k.get("library_ms"),
            "device_ms": k.get("device_ms"),
            "library_device_ms": k.get("library_device_ms"),
        })
    # K1-K3 against their plain versions on the app's frame
    # and on every call of a frame of ladder configs 1, 2 and 5
    for k in kernels:
        k["max_abs_err_app"] = paths["app"]["kernel_check"]["max_abs_err"][
            k["name"]]
        k["max_abs_err_ladder"] = lad["max_abs_err"].get(k["name"])
    # K2's bf16 color build beside its float32 one (bounce 0)
    kernels[1]["bf16"] = {
        key: b0["shade_bf16"][key] for key in (
            "max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
            "bound_by")}
    for kname, k, err, replaces in (
        ("radix_hist", rc, rc["max_abs_err"], "tools/radix_lab.py:109"),
        ("device_probe", pc["device_probe"],
         pc["max_abs_err"]["device_probe"], "tools/tpu_probe.py:117"),
        ("extract_probe", pc["extract_probe"],
         pc["max_abs_err"]["extract_probe"], "tools/roofline.py:129"),
        ("loop_probe", pc["loop_probe"], pc["max_abs_err"]["loop_probe"],
         "tools/event_lab.py:65"),
    ):
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"wavefront_tpu_torch/csrc/{kname}.cu",
            "replaces": replaces, "launches": lb["launches"][kname],
            "launches_by_path": {"labs": lb["launches"][kname]},
            "max_abs_err": err, "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k.get("library_ms"),
            "device_ms": k.get("device_ms"),
            "library_device_ms": k.get("library_device_ms"),
            "smem_floor_ms": k.get("smem_floor_ms"),
        })
    # the bounce sort's key and permute, which replace no TPU kernel:
    # times on the streamed window's bounce-1 rays, max |kernel - plain|
    # over its four sorted bounces
    b1 = rs["bounces"][1]
    for kname, k in (("ray_key", b1["key"]), ("ray_permute", b1["permute"])):
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "wavefront_tpu_torch/csrc/ray_sort.cu",
            "replaces": None, "launches": hl["launches"][kname],
            "launches_by_path": {p: v["launches"][kname]
                                 for p, v in paths.items()},
            "max_abs_err": rs["max_abs_err"][kname],
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "device_ms": k["device_ms"]})
    # the sparse NEE sweep, which replaces no TPU kernel: times on the
    # lamp-lit window's bounce-1 rays, the relative error over its four
    # bounces
    nb1 = ns["bounces"][1]
    kernels.append({
        "name": "nee_sweep", "route": "cuda",
        "source": "wavefront_tpu_torch/csrc/nee_sweep.cu", "replaces": None,
        "launches": gf["launches"]["nee_sweep"],
        "launches_by_path": {p: v["launches"]["nee_sweep"]
                             for p, v in paths.items()},
        "max_rel_err": ns["max_rel_err"], "ms": nb1["ms"],
        "plain_ms": nb1["plain_ms"], "bound_ms": nb1["bound_ms"],
        "bound_by": nb1["bound_by"], "device_ms": nb1["device_ms"]})
    # K5 also runs on the tools' path (onehot_ab)
    next(k for k in kernels if k["name"] == "loop_probe")[
        "launches_by_path"]["tools"] = tl["launches"]["loop_probe"]
    # K4's one-read form and its operations a call beside its one digit
    next(k for k in kernels if k["name"] == "radix_hist").update(
        {key: rc[key] for key in ("device_ops_per_call", "device_ms_one_read",
                                  "bound_ms_one_read")})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"{name}, {limit}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

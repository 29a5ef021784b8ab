"""Per-launch times of the port's kernels beside their bounds, and the
headline frame's device time, to compare two trees of the port on one
card.

    python wavefront_tpu_torch/tools/kernel_times.py [--root DIR]
        [--kernels K [K ...]] [--frames F] [--lamps L] [--reps N] [--sass]

DIR is a checkout whose `wavefront_tpu_torch` package is timed (default:
the one this file belongs to); it builds its own kernels under DIR.  Run
the file as a script: under `python -m` the package of the current
directory is imported before DIR can be put first, and the tool stops.

`--kernels` picks what is timed (default: trace shade).  Every kernel row
holds `ms` (CUDA events over `reps` launches back to back: where the
wrapper's host path is the longer, that is what it shows), `device_ms`
(the kernel's own device time a launch, from torch.profiler; null when
the profiler kept fewer than half of the launches), and `bound_ms` with
`bound_by`: the least time the card could take, the larger of the bytes
the launch must move (each read once and each written once) over
`_timing.HBM_BYTES_PER_S` and the operations its inputs ask for over
`_timing.UNFUSED_OPS_PER_S`, both counted from the launch's own inputs
(the rates are read from the `_timing.py` beside this file, whatever
DIR is, so both trees of a comparison get one bound):

  trace, shade  the tracer (K1) and the fused shade (K2) on the headline
                scene (1920x1080), on the bounce-0 rays sorted as the
                renderer sorts them and on the bounce-1 rays the shade
                makes from them; a row a kernel and bounce.  K1: 36 bytes
                a ray and the grids, or the plain march's fine crossings
                and skips; K2: 112 bytes a ray and its tables, or each
                live ray's shade and each hit ray's NEE over the light
                tables.  With `--lamps L` the scene also holds the first
                L lamp voxels of the general frame's lattice (six light
                prims each; up to 41 keep the set dense), to time the
                shade at a larger light set.
  shade_bf16    the fused shade's bf16 color build on the same rays, tp in
                bfloat16: 100 bytes a ray, and its roundings.
  texel         the texel fetch (K3) on the (tex, u, v) that the general
                frame's (`headline.general_setup`) first bounce hands it:
                12 bytes in and 4 a channel out a ray, the atlas once.
  radix         K4 at the headline's 2,073,600 keys, seeded (uniform
                over all 32 bits) and the headline frame's bounce-0
                coherence keys (their low 32 bits): a row a key set, its
                `ms` and `device_ms` one digit's (`digit_histogram`,
                shift 0), 4 bytes a key; beside it one read of four
                (`digit_histograms4`) and `radix_hist` with `one_read`
                and in four passes, per call the wall ms, the device ms
                of every device operation the call makes, their number
                and the device ms of the histogram kernel alone
                (`*_kernel_ms`).  Every call is one that earlier trees of
                the port have too.
  loop_probe    K5's onehot forms (smem, ldg, const) at 264 groups of 16
                rows: a 64-row table over 64 iterations and an 8-row one
                over 256; a row a form and table, the smem form's with
                `smem_floor_ms`, the least time its loop's shared loads
                (read from the build's machine code) take.
  extract_cur   K6's whole-scene read: 264 groups of 8 rows, 256
                iterations, a 160x160 table of 6 channels, lanes spread
                over it.
  extract_win   K6's window read: 264 groups of 8 rows, 256 iterations,
                25 windows of 8 channels, each group's lanes within 32
                voxels; with `smem_floor_ms`.
  row_gather    K7's `row_gather_sum` at R = 4096, reps 1 (one gather a
                launch: its time is the wrapper's host path), over
                GATHER_CALLS calls, beside `torch.gather` on the same
                table and indices; also the host clock's microseconds a
                call of each.
  ray_key, ray_permute
                the bounce sort's key (S1) and permute (S2) on the
                streamed window's (`headline.streamed_setup`) bounce-0 and
                bounce-1 rays as the renderer sorts them: 28 bytes a ray;
                the int64 permutation read once and every column read and
                written once.  The permute's row adds `torch.sort` on the
                key (`torch_sort_ms`).
  nee_sweep     the sparse NEE sweep (S3) on the lamp-lit window's
                (`headline.lamps_setup`) bounce-0 and bounce-1 rays: 44
                bytes a ray, or the operations of what its inputs ask
                (`nee_stats`: a plane test a live ray and prim, the rest
                of the test for a plane ahead, a walk level of a kept
                crossing).
  light_walk    the forward light walk (S4) on the lamp-lit window's
                bounce-0 rays: 33 bytes in and 17 out a ray and the node
                table once, or the operations of the levels its rays step
                (`walk_levels`: two box importances, the branch and the
                draw a level); beside it the plain walk's time
                (`plain_ms`, `light_walk_plain` on the same rays).
  tri_sweep     the entity triangle sweep (S5) on the game world's
                (`app/main.py::build_world`: the radius-6 window and the
                ego cube) bounce-0 rays as the renderer sorts them, a row
                a form: the sweep (24 bytes in and 21 out a ray, the pool
                once) and the fused shade's stream form (32 in and 52 out,
                the pool with its uv and textures), or the operations of
                a ray's tests against the active triangles
                (`tri_sweep_bound_ms`); beside each its plain version's
                time (`plain_ms`: `triangle_sweep_plain`,
                `entity_attrs_plain`, on the same rays).

`--frames F` adds one line for the headline frame: `frame_ms` over F
frames (host clock, ending in a synchronize) and, over F more frames
under torch.profiler, the device's busy ms a frame and idle share.
`--blocks B` times B such blocks of F frames, each ending in a
synchronize: `frame_ms` is then their median and `blocks_ms` each
block's, which a slow block on a shared host moves less.

`--sass` adds one line for the fused shade's machine code (`cuobjdump
-sass` of the tree's build): per kernel instantiation, named with its
template arguments, the count of instructions and a hash of their text,
so two trees' builds of one instantiation can be told equal or not.

Every line is one JSON object with the card's name and power limit and
the tree's root.  Compare two trees within one machine, in turns (A, B,
B, A).  Whether each kernel equals its plain version is the business of
the card tests (`tests/test_torch_card_paths.py` names them).
"""

from __future__ import annotations

import argparse
import functools
import importlib.util
import json
import os
import statistics
import sys
import time

KERNELS = ("trace", "shade", "shade_bf16", "texel", "loop_probe",
           "extract_cur", "extract_win", "row_gather", "radix", "ray_key",
           "ray_permute", "nee_sweep", "light_walk", "tri_sweep")
GATHER_ROWS = 4096
GATHER_CALLS = 1000

# Operations per unit of work, tallied from the kernel sources (compares,
# selects, conversions, integer and float arithmetic, loads; no branches
# or loop control), none of them fused (-fmad=false).
# One fine crossing of the tracer: axis pick 5, the step, its range check
# and index move 3, the aux load 1, the face rule 6, the hit window 3, the
# march test 1, the stepped axis's crossing time 5, the skip test 1.
TRACE_OPS_PER_FINE = 25
# One skip: radius 2, three cube exits 18, their minimum and the landing
# 3, the landing voxel 12, range and clip tests 4, flat index 4, the aux
# load 1, three crossing times 15, the skip test 1.
TRACE_OPS_PER_SKIP = 60
# The shade of one live ray without NEE (hit point, face frame, uv,
# emission, scatter, hemisphere sample, branch merge, throughput fold).
SHADE_OPS_PER_RAY = 160
# NEE, once per NEE ray: one box importance (45) per live node with its
# share of the sibling sum, the divide, clamps, select and log (52); one
# add per path node; per prim its exp and the pick's running sums (5) and
# a plane/quad test in the pdf sweep (40); the picked prim's importance.
SHADE_OPS_PER_NODE = 52
SHADE_OPS_PER_PICK_PRIM = 5
SHADE_OPS_PER_PDF_PRIM = 40
SHADE_OPS_PER_PICKED = 45
# The bf16 color build, beside that: 23 roundings of a color to bf16
# (3 reflectivity, cos_in, 9 in the emission, 3 lambertian reflectivity,
# the MIS weight, 3 radiance terms, 3 throughput factors), each a narrowing
# and a widening, and the throughput's 3 loads widened and 3 stores
# narrowed.
SHADE_BF16_OPS_PER_RAY = 23 * 2 + 6
# The texel fetch of one ray: two multiplies and the float side of two
# saturating conversions and clamps.
TEXEL_OPS_PER_RAY = 8
# The sparse NEE sweep (csrc/nee_sweep.cu): a ray's activity test, cosine,
# loads and stores (16); for every prim its plane test: the denominator
# and its test 7, the numerator 8, the numerator's sign 2; for a plane
# ahead within T_MAX the divide, its range test 3, the hit point 9, r1 and
# r2 10, u and v 8, the inside test 8; for each level of a kept crossing's
# reverse walk two box importances of 66 (12 corner offsets, 28 corner
# sums, tests and counts, 8 for the diagonal, 9 for the centre, 6 for the
# distance, 3 for the quotient) and the branch 5.
NEE_OPS_PER_RAY = 16
NEE_OPS_PER_PLANE = 17
NEE_OPS_PER_AHEAD = 38
NEE_OPS_PER_LEVEL = 2 * 66 + 5
# The forward light walk (csrc/light_walk.cu): a ray's loads, activity
# tests, outputs and its prim's read (19); for each level it steps two box
# importances of 66 (S3's, above: csrc/light_bvh.cuh), the branch
# probability 5, the draw 12 (the finalizer 8, the float 3, its test 1)
# and the step 10 (the selects of node, probability and importance, the
# children, the seed's next round and the loop test).
WALK_OPS_PER_RAY = 19
WALK_OPS_PER_LEVEL = 2 * 66 + 5 + 12 + 10
# S5 (the entity triangle sweep), by form (False: the sweep, True: the
# fused shade's stream form): per ray origin and direction in, hit, t,
# the int64 slot and two barycentrics out (the stream form: pa and t in
# too, the merged t and K2's 12 stream words out); the pool's vertices
# and active flag once (and its uv and textures); the plain sweep's
# elementwise operations, per ray and active triangle the two crosses,
# det and its test, 1 / det, u, v, t, the range and direction tests, the
# select and the arg-min, per ray the direction test, the winner's
# gathers and its slot (the stream form: the merge, the texture's clamp
# and flag and the merged t in place of the slot's)
TRI_BYTES_PER_RAY = {False: 24 + 21, True: 32 + 52}
TRI_BYTES_PER_SLOT = {False: 37, True: 65}
TRI_OPS_PER_TEST = 64
TRI_OPS_PER_RAY = {False: 11, True: 18}
# Integer operations of the histogram and the probes, set against the
# float32 rate (the card's published table has no int32 rate; its int32
# rate is lower, so the bound stays a lower bound).  A key's digit (shift,
# mask) and its count:
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


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))),
        help="checkout holding the wavefront_tpu_torch package to time")
    ap.add_argument("--kernels", nargs="+", choices=KERNELS,
                    default=["trace", "shade"], help="what to time")
    ap.add_argument("--frames", type=int, default=0,
                    help="headline frames to time and profile (0: none)")
    ap.add_argument("--blocks", type=int, default=1,
                    help="blocks of --frames frames timed (median)")
    ap.add_argument("--lamps", type=int, default=0,
                    help="lamp voxels of the lattice added to the scene")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--sass", action="store_true",
                    help="hash the fused shade's machine code")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)

    import wavefront_tpu_torch
    if not os.path.abspath(wavefront_tpu_torch.__file__).startswith(
            os.path.join(root, "")):
        raise SystemExit(
            f"kernel_times: the package was imported from "
            f"{wavefront_tpu_torch.__file__}, not from {root}; run this file "
            "as a script (python wavefront_tpu_torch/tools/kernel_times.py)")
    from wavefront_tpu_torch.tools._timing import card, require_card

    require_card()
    name, limit = card()
    kernels = set(args.kernels)

    def emit(rows):
        for row in rows:
            print(json.dumps({"root": root, **row, "card": name,
                              "power_limit": limit}), flush=True)

    if {"trace", "shade", "shade_bf16"} & kernels:
        emit(trace_shade_rows(args))
    if "texel" in kernels:
        emit([texel_row(args.reps)])
    for kernel in ("loop_probe", "extract_cur", "extract_win"):
        if kernel in kernels:
            emit(probe_rows(kernel, args.reps))
    if "row_gather" in kernels:
        emit([gather_row()])
    if "radix" in kernels:
        emit(radix_rows(args.reps))
    if {"ray_key", "ray_permute"} & kernels:
        emit(sort_rows(kernels, args.reps))
    if "nee_sweep" in kernels:
        emit(nee_rows(args.reps))
    if "light_walk" in kernels:
        emit([walk_row(args.reps)])
    if "tri_sweep" in kernels:
        emit(tri_sweep_rows(args.reps))
    if args.frames:
        emit([frame_row(args.frames, args.blocks)])
    if args.sass:
        emit([shade_sass_row()])
    return 0


# ---- bounds ----


@functools.lru_cache(maxsize=None)
def rates():
    """The `_timing.py` beside this file, loaded by its path: the card's
    rates that the bounds divide by come from the tool's own tree, not
    from the tree that `--root` puts first on the import path."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "_timing.py")
    spec = importlib.util.spec_from_file_location("_kernel_times_rates",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def max_bound(nbytes: int, ops: int) -> tuple:
    """(bound_ms, bound_by): the larger of `nbytes` at the card's memory
    rate and `ops` at its rate of unfused operations."""
    by_bytes = nbytes / rates().HBM_BYTES_PER_S * 1e3
    by_ops = ops / rates().UNFUSED_OPS_PER_S * 1e3
    if by_bytes >= by_ops:
        return by_bytes, "bytes"
    return by_ops, "operations"


def trace_bound_ms(arrays, n: int, fine: int, skips: int) -> tuple:
    """K1: origin and direction in, pa, pb and t out, the grid and aux
    grid read once; or the operations of the steps the rays take (fine
    crossings and skips, from the plain version's march)."""
    nbytes = n * 36 + arrays.grid.numel() + arrays.aux_grid.numel()
    return max_bound(nbytes, fine * TRACE_OPS_PER_FINE
                     + skips * TRACE_OPS_PER_SKIP)


def shade_bytes(tables, n: int, n_entity=None, bf16: bool = False) -> int:
    """Bytes one K2 launch over `n` rays moves: 16 words in and 12 out a
    ray (bf16: 100 bytes, the throughput 2 bytes a component each way),
    the atlas and light tables read once.  With the entity stream
    (n_entity: the lanes an entity wins) the flag word is read on every
    ray and the other 11 words on those lanes."""
    stream = 0 if n_entity is None else n * 4 + n_entity * 44
    return (n * (100 if bf16 else 112) + stream
            + sum(t.numel() * t.element_size()
                  for t in (tables.atlas, tables.nodes, tables.prims)))


def shade_bound_ms(tables, n: int, n_alive: int, n_hit: int, nee: bool,
                   n_entity=None, bf16: bool = False) -> tuple:
    """K2: `shade_bytes`, or its float32 operations (bf16: and its
    conversions); every hit ray counted as an NEE ray (mirror and glass
    hits take none; the headline's are few)."""
    ops = n_alive * (SHADE_OPS_PER_RAY
                     + (SHADE_BF16_OPS_PER_RAY if bf16 else 0))
    if nee:
        prims = len(tables.paths)
        ops += n_hit * ((tables.live - 1) * SHADE_OPS_PER_NODE
                        + sum(len(p) for p in tables.paths)
                        + prims * (SHADE_OPS_PER_PICK_PRIM
                                   + SHADE_OPS_PER_PDF_PRIM)
                        + SHADE_OPS_PER_PICKED)
    return max_bound(shade_bytes(tables, n, n_entity, bf16), ops)


def tri_sweep_bytes(n: int, slots: int, stream: bool = False) -> int:
    """Bytes one S5 launch over `n` rays and a pool of `slots` moves."""
    return n * TRI_BYTES_PER_RAY[stream] + slots * TRI_BYTES_PER_SLOT[stream]


def tri_sweep_ops(n: int, active: int, stream: bool = False) -> int:
    """Operations one S5 launch over `n` rays and `active` triangles
    computes."""
    return n * (TRI_OPS_PER_RAY[stream] + active * TRI_OPS_PER_TEST)


def tri_sweep_bound_ms(n: int, slots: int, active: int,
                       stream: bool = False) -> tuple:
    """S5: its bytes, or its ray-triangle tests' operations."""
    return max_bound(tri_sweep_bytes(n, slots, stream),
                     tri_sweep_ops(n, active, stream))


def texel_bytes(atlas, n: int, nch: int) -> int:
    """Bytes one K3 launch moves: tex, u and v in and `nch` floats out a
    ray, the atlas read once."""
    return n * (12 + 4 * nch) + atlas.numel() * atlas.element_size()


def texel_bound_ms(atlas, n: int, nch: int) -> tuple:
    return max_bound(texel_bytes(atlas, n, nch), n * TEXEL_OPS_PER_RAY)


def nee_stats(lights, o, d, mis, max_depth: int) -> tuple:
    """What the sparse sweep's inputs ask of it, from the plain version's
    crossing test (`_prim_tile_hits`) in 64-prim tiles: (each ray's
    crossings, 0 for a ray with no MIS weight or no direction; the live
    rays; the (ray, prim) pairs of live rays with the plane ahead within
    T_MAX; the walk levels of every crossing, the depth of its prim's
    leaf, at most max_depth)."""
    import numpy as np
    import torch

    from wavefront_tpu_torch.core.config import EPSILON_NEE, T_MAX
    from wavefront_tpu_torch.render.wavefront import _prim_tile_hits

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


def walk_levels(lights, success, prim, active, max_depth: int) -> int:
    """The levels the forward walk's rays stepped, from its result: a ray
    that reached its leaf stepped the leaf's depth, an active one that did
    not ran out of levels (max_depth); none on a set whose root is a leaf
    or that has no lights."""
    import numpy as np

    left = lights.node_left.cpu().numpy()
    if not 0 <= left[0] != 0xFFFFFFFF:
        return 0
    parent = lights.node_parent.cpu().numpy()
    leaves = lights.leaf_node.cpu().numpy()[:lights.num_prims]
    depth = np.zeros(len(leaves), np.int64)
    for j, leaf in enumerate(leaves):
        k = int(leaf)
        while 0 <= parent[k] != 0xFFFFFFFF:
            k, depth[j] = int(parent[k]), depth[j] + 1
    return int(depth[prim[success].cpu().numpy()].sum()) \
        + max_depth * int((active & ~success).sum())


def smem_floor_ms(lane_iters: int, sass: dict, per_pass: int) -> float:
    """The least time the shared loads of `lane_iters` lane-iterations
    take: the loop's loads (`event_lab.probe_loop_sass`, a pass of the
    loop being `per_pass` lane-iterations) each counted as at least one
    4-byte bank slot, at `_timing.SMEM_BYTES_PER_S`."""
    return lane_iters * sass["shared_bank_bytes"] / per_pass \
        / rates().SMEM_BYTES_PER_S * 1e3


# ---- rows ----


def kernel_row(kernel: str, record: str, fn, reps: int, bound: tuple,
               **fields) -> dict:
    """One kernel's row: `fields`, then `ms` (CUDA events), `device_ms`
    (the device time of the records named `record`, a launch) and the
    bound."""
    from wavefront_tpu_torch.tools._sweep import kernel_device_ms
    from wavefront_tpu_torch.tools._timing import time_ms

    return {"kernel": kernel, **fields, "ms": time_ms(fn, reps),
            "device_ms": kernel_device_ms(fn, record, reps),
            "bound_ms": bound[0], "bound_by": bound[1]}


def trace_shade_rows(args):
    import torch

    from wavefront_tpu_torch.core.config import WorldSettings
    from wavefront_tpu_torch.core.vec3 import V3, any_nonzero
    from wavefront_tpu_torch.headline import (
        ASSETS,
        build_scene,
        headline_setup,
        lamp_lattice,
    )
    from wavefront_tpu_torch.kernels.shade import prep_shade_tables, shade_pass
    from wavefront_tpu_torch.kernels.window_trace import (
        auto_events,
        window_trace,
    )
    from wavefront_tpu_torch.render.intersect import trace_plain
    from wavefront_tpu_torch.render.renderer import coherence_sort
    from wavefront_tpu_torch.render.scene import VoxelScene
    from wavefront_tpu_torch.render.wavefront import raygen_soa
    from wavefront_tpu_torch.world.blocks import BlockRegistry

    scene, settings, basis, _ = headline_setup(1920, 1080, 4, device="cuda")
    if args.lamps:
        registry = BlockRegistry.load(ASSETS)
        grid, origin = build_scene(registry, WorldSettings())
        for cell in lamp_lattice(grid, registry)[:args.lamps]:
            grid[cell] = registry.block_idx("lamp")
        scene = VoxelScene(registry, grid, origin, max_light_prims=256,
                           device="cuda")
    arrays = scene.get_arrays()
    tables = prep_shade_tables(arrays.atlas_packed, arrays.lights)
    w, h = settings.render_width, settings.render_height
    n = w * h
    o, d, rid = raygen_soa(basis.eye, basis.front, basis.right, basis.up,
                           w, h, device="cuda")
    tp = V3(*(torch.ones(n, device="cuda") for _ in range(3)))
    rad = V3(*(torch.zeros(n, device="cuda") for _ in range(3)))
    events = auto_events(*arrays.grid.shape)
    for b in range(2):
        o, d, tp, rad, rid = coherence_sort(arrays, o, d, tp, rad, rid)
        stats = {}
        pa, pb, t = trace_plain(arrays, o, d, events, stats=stats)
        shade_args = (tables, arrays.grid_origin, o, d, pa, pb, t, tp, rad,
                      rid, b, b, arrays.lights.num_prims)
        alive = int(any_nonzero(d).sum())
        hits = int(((pa & 1) != 0).sum())
        common = {"bounce": b, "rays": n, "alive": alive,
                  "light_prims": int(arrays.lights.num_prims),
                  "light_nodes": tables.m_nodes}
        if "trace" in args.kernels:
            yield kernel_row(
                "trace", "trace_kernel",
                lambda: window_trace(arrays, o, d, events), args.reps,
                trace_bound_ms(arrays, n, stats["fine"], stats["skips"]),
                **common)
        if "shade" in args.kernels:
            yield kernel_row(
                "shade", "shade_kernel",
                lambda: shade_pass(*shade_args, nee_type=1), args.reps,
                shade_bound_ms(tables, n, alive, hits, True), **common)
        if "shade_bf16" in args.kernels:
            args16 = shade_args[:7] + (
                tp.map(lambda c: c.to(torch.bfloat16)),) + shade_args[8:]
            yield kernel_row(
                "shade_bf16", "shade_kernel",
                lambda: shade_pass(*args16, nee_type=1, color_bf16=True),
                args.reps,
                shade_bound_ms(tables, n, alive, hits, True, bf16=True),
                **common)
        o, d, tp, rad = (V3(*(c.contiguous() for c in v))
                         for v in shade_pass(*shade_args, nee_type=1))


def shade_sass_row() -> dict:
    """The fused shade's machine code per kernel instantiation of the
    tree's build: {"shade_kernel<P,TRI[,BF16]>": {"instructions", "sha256"
    (the first 16 hex digits, of the instructions' text without their
    addresses and encodings)}}."""
    import hashlib
    import re
    import subprocess

    from wavefront_tpu_torch.kernels import _build

    lib = _build.library_path("shade")
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    code, cur = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : \S*?shade_kernelI((?:L[a-z]-?\d+E)+)E",
                      line)
        if m:
            args = re.findall(r"L[a-z](-?\d+)E", m.group(1))
            cur = f"shade_kernel<{','.join(args)}>"
            code[cur] = []
            continue
        if "Function :" in line:
            cur = None
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if cur and m:
            code[cur].append(m.group(1).strip())
    return {"kernel": "shade_sass", "library": os.path.basename(lib),
            "functions": {k: {"instructions": len(v), "sha256": hashlib.sha256(
                "\n".join(v).encode()).hexdigest()[:16]}
                for k, v in sorted(code.items())}}


def texel_row(reps: int) -> dict:
    from wavefront_tpu_torch.headline import general_setup
    from wavefront_tpu_torch.kernels.texel import texel_fetch
    from wavefront_tpu_torch.render.renderer import render_frame

    scene, settings, basis, prefs = general_setup(1920, 1080, 4,
                                                  device="cuda")
    seen = []

    def spy(atlas, tex, u, v, channels=None):
        seen.append((atlas, tex, u, v, channels))
        return texel_fetch(atlas, tex, u, v, channels=channels)

    render_frame(scene.get_arrays(), basis.eye, basis.front, basis.right,
                 basis.up, 0, settings=settings.replace(num_bounces=1),
                 nee_type=prefs.nee_type, sort_type=prefs.sort_type,
                 texel=spy, use_entities=bool(scene._entities))
    atlas, tex, u, v, chans = seen[0]
    n = int(tex.shape[0])
    return kernel_row(
        "texel", "texel_kernel",
        lambda: texel_fetch(atlas, tex, u, v, channels=chans), reps,
        texel_bound_ms(atlas, n, len(chans)), rays=n, channels=list(chans))


def probe_rows(kernel: str, reps: int):
    import numpy as np
    import torch

    from wavefront_tpu_torch.kernels import extract_probe, loop_probe
    from wavefront_tpu_torch.tools import event_lab, roofline
    from wavefront_tpu_torch.tools._timing import FILL_GROUPS

    rng = np.random.default_rng(5)

    def i32(a):
        return torch.as_tensor(a.astype(np.int32), device="cuda")

    def u8(shape):
        return torch.as_tensor(rng.integers(0, 255, shape).astype(np.uint8),
                               device="cuda")

    common = {"groups": FILL_GROUPS}
    if kernel == "loop_probe":
        shape = (FILL_GROUPS, 16, 128)
        lanes = FILL_GROUPS * 16 * 128
        state = (i32(rng.integers(0, 100, shape)),
                 torch.zeros(shape, dtype=torch.int32, device="cuda"))
        for nr, iters in ((64, 64), (8, 256)):
            table = u8((nr, 128))
            # the state's two int32 words in and out a lane
            bound = max_bound(table.numel() + 16 * lanes, lanes * iters * (
                nr // LOOP_BYTES_PER_OP + LOOP_OPS_PER_ITER))
            for form in ("smem", "ldg", "const"):
                row = kernel_row(
                    "loop_probe", "loop_kernel",
                    lambda: loop_probe.loop_probe(f"onehot_{form}", state,
                                                  table, iters), reps,
                    bound, form=form, rows=16, table_rows=nr, iters=iters,
                    **common)
                if form == "smem":
                    # 16 rows of a group are 512 threads of 4 lanes; a
                    # pass of the loop is one iteration of each
                    row["smem_floor_ms"] = smem_floor_ms(
                        lanes * iters, event_lab.probe_loop_sass(
                            "loop_probe", rf"loop_kernelILi1ELi{nr}ELi4EE"),
                        4)
                yield row
        return
    # the lanes of roofline's rows: uniform over the scene, or each group
    # within 32 voxels of its own base; cx, cz and the result a lane
    lanes, iters = FILL_GROUPS * 8 * 128, 256
    if kernel == "extract_cur":
        table = u8((6, 160, 160))
        cx, cz = roofline._lanes(rng, FILL_GROUPS, 8, 160, 160)
        yield kernel_row(
            kernel, "cur_kernel",
            lambda: extract_probe.extract_cur(table, cx, cz, iters), reps,
            max_bound(table.numel() + 12 * lanes,
                      lanes * iters * (6 + EXTRACT_OPS_PER_ITER)),
            rows=8, iters=iters, **common)
        return
    tw = u8((25, 64, 128))
    cx, cz = roofline._lanes(rng, FILL_GROUPS, 8, 160, 160, roofline.SPREAD)
    row = kernel_row(
        kernel, "win_kernel",
        lambda: extract_probe.extract_win(tw, cx, cz, iters, 5, 5), reps,
        max_bound(tw.numel() + 12 * lanes, lanes * iters * (
            EXTRACT_WIN_FOLD_OPS + EXTRACT_OPS_PER_ITER)),
        rows=8, iters=iters, **common)
    # 8 rows of a group are 512 threads of 2 lanes; a pass of the window
    # loop is 8 iterations of 2 lanes, its stage included
    row["smem_floor_ms"] = smem_floor_ms(
        lanes * iters,
        event_lab.probe_loop_sass("extract_probe", r"win_kernelILi2ELi8EE"),
        16)
    yield row


def _host_us(fn, calls: int) -> float:
    """Host-clock microseconds a call over `calls` calls (the queue
    drained before, not after)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    dt = time.perf_counter_ns() - t0
    torch.cuda.synchronize()
    return dt / calls / 1e3


def gather_row() -> dict:
    import numpy as np
    import torch

    from wavefront_tpu_torch.kernels.device_probe import row_gather_sum
    from wavefront_tpu_torch.tools._timing import time_ms

    rng = np.random.default_rng(5)
    shape = (GATHER_ROWS, 128)
    t = torch.as_tensor(rng.integers(0, 100, shape).astype(np.int32),
                        device="cuda")
    i = torch.as_tensor(rng.integers(0, GATHER_ROWS, shape).astype(np.int32),
                        device="cuda")
    i64 = i.to(torch.int64)
    k7 = (lambda: row_gather_sum(t, i, 1))
    lib = (lambda: torch.gather(t, 0, i64))
    # table and indices in, the sums out; an add a lane
    row = kernel_row("row_gather", "row_gather_kernel", k7, GATHER_CALLS,
                     max_bound(3 * 4 * t.numel(), t.numel()),
                     rows=GATHER_ROWS, calls=GATHER_CALLS)
    return {**row, "reps": 1, "torch_gather_ms": time_ms(lib, GATHER_CALLS),
            "row_gather_host_us": _host_us(k7, GATHER_CALLS),
            "torch_gather_host_us": _host_us(lib, GATHER_CALLS)}


def radix_device(fn, reps: int) -> tuple:
    """(device ms, device operations, device ms of the histogram kernel)
    a call of `fn`, which calls K4's wrappers: every device operation
    (kernels, fills) that `torch.profiler` records over `reps` calls,
    after one warm-up call, per call whose histogram kernels it kept (the
    wrappers' launch counters say how many a call launches).  A profiler
    that has run long in a process may drop a share of the device events;
    (None, None, None) when it kept fewer than half of the calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from wavefront_tpu_torch.kernels import radix_hist as rh
    from wavefront_tpu_torch.utils.spans import device_events

    def launches():
        return rh.digit_histogram.launches + rh.digit_histograms4.launches

    fn()
    torch.cuda.synchronize()
    before = launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per_call = (launches() - before) / reps
    dev = device_events(prof)
    kern = [e.device_time for e in dev if "hist_kernel" in e.name]
    calls = len(kern) / per_call
    if calls * 2 <= reps:
        return None, None, None
    return (sum(e.device_time for e in dev) / 1e3 / calls, len(dev) / calls,
            sum(kern) / 1e3 / calls)


def radix_keys(scene, settings, basis) -> dict:
    """The headline's count of keys as int32 key bits on the card: seeded
    (`radix_lab.SEED`) and the low 32 bits of the coherence keys of the
    frame's bounce-0 rays (`scene`, `settings`, `basis` from
    `headline.headline_setup`)."""
    import numpy as np
    import torch

    from wavefront_tpu_torch.headline import HEADLINE_RAYS
    from wavefront_tpu_torch.kernels.radix_hist import as_key_bits
    from wavefront_tpu_torch.kernels.window_trace import coherence_key
    from wavefront_tpu_torch.render.wavefront import raygen_soa
    from wavefront_tpu_torch.tools.radix_lab import SEED

    rng = np.random.default_rng(SEED)
    seeded = torch.as_tensor(rng.integers(0, 2 ** 32, HEADLINE_RAYS,
                                          dtype=np.uint32).view(np.int32),
                             device="cuda")
    arrays = scene.get_arrays()
    o, d, _ = raygen_soa(basis.eye, basis.front, basis.right, basis.up,
                         settings.render_width, settings.render_height,
                         device="cuda")
    go = arrays.grid_origin
    frame = as_key_bits(coherence_key(
        o.x - float(go[0]), o.y - float(go[1]), o.z - float(go[2]),
        d.x, d.y, d.z, *arrays.grid.shape))
    return {"seeded": seeded, "frame": frame}


def radix_rows(reps: int):
    from wavefront_tpu_torch.headline import headline_setup
    from wavefront_tpu_torch.kernels import radix_hist as rh
    from wavefront_tpu_torch.tools._timing import time_ms

    calls = {"one_digit": lambda k: rh.digit_histogram(k, 0),
             "one_read": rh.digit_histograms4,
             "radix_hist_1read": lambda k: rh.radix_hist(k, one_read=True),
             "radix_hist_4pass": rh.radix_hist}
    scene, settings, basis, _ = headline_setup(1920, 1080, 4, device="cuda")
    for name, keys in radix_keys(scene, settings, basis).items():
        n = int(keys.shape[0])
        row = {"kernel": "radix", "keys": name, "n": n, "reps": reps}
        for call, fn in calls.items():
            row[f"{call}_ms"] = time_ms(lambda: fn(keys), reps)
            (row[f"{call}_device_ms"], row[f"{call}_device_ops"],
             row[f"{call}_kernel_ms"]) = radix_device(lambda: fn(keys), reps)
        # the keys in and 256 counts out; a digit and its count a key
        bound, by = max_bound(4 * n + 4 * 256, n * HIST_OPS_PER_KEY)
        one, one_by = max_bound(4 * n + 4 * 4 * 256, n * 4 * HIST_OPS_PER_KEY)
        yield {**row, "ms": row["one_digit_ms"],
               "device_ms": row["one_digit_kernel_ms"], "bound_ms": bound,
               "bound_by": by, "one_read_bound_ms": one,
               "one_read_bound_by": one_by}


def _spied(module, name: str, keep, render) -> None:
    """`render()` with `module.<name>` replaced by a function that hands
    each call's arguments to `keep(*args, **kw)` before the real one."""
    real = getattr(module, name)

    def spy(*a, **kw):
        keep(*a, **kw)
        return real(*a, **kw)

    setattr(module, name, spy)
    try:
        render()
    finally:
        setattr(module, name, real)


def sort_rows(kernels, reps: int):
    import torch

    from wavefront_tpu_torch.core.vec3 import any_nonzero
    from wavefront_tpu_torch.headline import streamed_setup
    from wavefront_tpu_torch.kernels.ray_sort import ray_key, ray_permute
    from wavefront_tpu_torch.render import renderer as rr
    from wavefront_tpu_torch.tools._timing import time_ms

    scene, _, settings, basis, prefs = streamed_setup(1920, 1080, 4,
                                                      device="cuda")
    seen = []
    _spied(rr, "coherence_sort",
           lambda arrays, o, d, tp, rad, rid, *riders, key=None: seen.append(
               (arrays, o, d, [*o, *d, *tp, *rad, rid], key)),
           lambda: rr.Renderer(settings, device="cuda").render(
               scene, basis, prefs, frame_count=5))
    for b, (arrays, o, d, cols, key) in enumerate(seen[:2]):
        go, shape = arrays.grid_origin, arrays.grid.shape
        n = int(o.x.shape[0])
        common = {"bounce": b, "rays": n, "alive": int(any_nonzero(d).sum())}
        if "ray_key" in kernels:
            # origin and direction in, the key out
            yield kernel_row("ray_key", "ray_key_kernel",
                             lambda: ray_key(o, d, go, shape), reps,
                             max_bound(28 * n, 0), **common)
        if "ray_permute" in kernels:
            perm = torch.sort(key, stable=True).indices
            nbytes = (8 + 2 * sum(c.element_size() for c in cols)) * n
            row = kernel_row("ray_permute", "ray_permute_kernel",
                             lambda: ray_permute(perm, cols), reps,
                             max_bound(nbytes, 0), columns=len(cols),
                             **common)
            row["torch_sort_ms"] = time_ms(
                lambda: torch.sort(key, stable=True), reps)
            yield row


def nee_rows(reps: int):
    import torch

    from wavefront_tpu_torch.headline import lamps_setup
    from wavefront_tpu_torch.kernels.nee_sweep import nee_sweep
    from wavefront_tpu_torch.render import renderer as rr

    scene, _, settings, basis, prefs = lamps_setup(1920, 1080, 4,
                                                   device="cuda")
    seen = []
    _spied(rr, "nee_pdf_sweep",
           lambda lights, point, normal, direction, mis, *a, **kw:
           seen.append((lights, point, normal, direction, mis)),
           lambda: rr.Renderer(settings, device="cuda").render(
               scene, basis, prefs, frame_count=5))
    depth, hits = settings.max_bvh_depth, settings.max_nee_hits
    for b, (lights, o, nrm, d, mis) in enumerate(seen[:2]):
        n = int(mis.shape[0])
        crossings, live, ahead, levels = nee_stats(lights, o, d, mis, depth)
        tests = live * lights.num_prims
        ops = (n * NEE_OPS_PER_RAY + tests * NEE_OPS_PER_PLANE
               + ahead * NEE_OPS_PER_AHEAD + levels * NEE_OPS_PER_LEVEL)
        counts = torch.zeros(2, dtype=torch.int64, device="cuda")
        # a ray's point, normal, direction and MIS weight in, its pdf out
        yield kernel_row(
            "nee_sweep", "nee_sweep_kernel",
            lambda: nee_sweep(lights, o, nrm, d, mis, depth, hits, counts),
            reps, max_bound(44 * n, ops), bounce=b, rays=n, live=live,
            light_prims=int(lights.num_prims), tests=tests, ahead=ahead,
            crossings=int(crossings.sum()), walk_levels=levels)


def walk_row(reps: int) -> dict:
    from wavefront_tpu_torch.headline import lamps_setup
    from wavefront_tpu_torch.kernels.light_walk import light_walk
    from wavefront_tpu_torch.render import renderer as rr
    from wavefront_tpu_torch.render.wavefront import light_walk_plain
    from wavefront_tpu_torch.tools._timing import time_ms

    scene, _, settings, basis, prefs = lamps_setup(1920, 1080, 4,
                                                   device="cuda")
    seen = []
    _spied(rr, "traverse_light_bvh",
           lambda *a: seen.append(a),
           lambda: rr.Renderer(settings, device="cuda").render(
               scene, basis, prefs, frame_count=5))
    lights, point, normal, seed, active, depth = seen[0]
    n = int(active.shape[0])
    success, prim = light_walk(lights, point, normal, seed, active,
                               depth)[:2]
    levels = walk_levels(lights, success, prim, active, depth)
    m = lights.node_min.shape[0]
    # each node's bounds, power and children read once
    nbytes = 50 * n + m * 44
    ops = n * WALK_OPS_PER_RAY + levels * WALK_OPS_PER_LEVEL
    row = kernel_row(
        "light_walk", "light_walk_kernel",
        lambda: light_walk(lights, point, normal, seed, active, depth),
        reps, max_bound(nbytes, ops), bounce=0, rays=n,
        active=int(active.sum()), node_rows=int(m),
        light_prims=int(lights.num_prims), walk_levels=levels)
    row["plain_ms"] = time_ms(
        lambda: light_walk_plain(lights, point, normal, seed, active, depth),
        3)
    return row


def tri_sweep_rows(reps: int):
    import argparse

    from wavefront_tpu_torch.app.main import build_world
    from wavefront_tpu_torch.kernels.tri_sweep import tri_sweep
    from wavefront_tpu_torch.render import renderer as rr
    from wavefront_tpu_torch.render.intersect import triangle_sweep_plain
    from wavefront_tpu_torch.tools._timing import time_ms

    world = build_world(argparse.Namespace(
        width=1920, height=1080, bounces=4, max_steps=192, nee_type=1,
        sort_type=0, window_chunks=None, assets=None, headless=False,
        device="cuda", accumulate=False, drop_cubes=0))
    cm = world.managers[0]
    cm.synchronous, cm._async_rebuild_opt = True, False
    world.step()
    seen = []
    _spied(rr, "entity_stream", lambda *a: seen.append(a), world.step)
    args = seen[0]
    verts, active, o, d = args[0], args[1], args[5], args[6]
    pa, t, t_min, t_max = args[7:11]
    arrays = world.scene.get_arrays()
    n, slots, live = int(o.x.shape[0]), int(active.shape[0]), \
        int(active.sum())
    common = {"bounce": 0, "rays": n, "slots": slots, "active": live}
    row = kernel_row(
        "tri_sweep", "tri_sweep_kernel",
        lambda: tri_sweep(verts, active, o, d, t_min, t_max), reps,
        tri_sweep_bound_ms(n, slots, live), form="sweep", **common)
    row["plain_ms"] = time_ms(
        lambda: triangle_sweep_plain(verts, active, o, d), 3)
    yield row
    row = kernel_row(
        "tri_sweep", "tri_sweep_kernel", lambda: rr.entity_stream(*args),
        reps, tri_sweep_bound_ms(n, slots, live, True), form="stream",
        **common)
    row["plain_ms"] = time_ms(
        lambda: rr.entity_attrs_plain(arrays, o, d, pa, t), 3)
    yield row


def frame_row(frames: int, blocks: int = 1) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from wavefront_tpu_torch.headline import headline_setup
    from wavefront_tpu_torch.render.renderer import Renderer
    from wavefront_tpu_torch.utils.spans import device_events

    scene, settings, basis, prefs = headline_setup(1920, 1080, 4,
                                                   device="cuda")
    r = Renderer(settings)
    r.render(scene, basis, prefs, frame_count=0, as_numpy=False)
    torch.cuda.synchronize()
    blocks_ms = []
    for b in range(blocks):
        t0 = time.perf_counter()
        for f in range(1, frames + 1):
            r.render(scene, basis, prefs, frame_count=b * frames + f,
                     as_numpy=False)
        torch.cuda.synchronize()
        blocks_ms.append((time.perf_counter() - t0) * 1e3 / frames)
    frame_ms = statistics.median(blocks_ms)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for f in range(frames):
            r.render(scene, basis, prefs, frame_count=100 + f,
                     as_numpy=False)
        torch.cuda.synchronize()
    dev = device_events(prof)
    busy = sum(e.device_time for e in dev) / 1e3 / frames
    return {"frame": "headline", "frames": frames, "frame_ms": frame_ms,
            "blocks_ms": blocks_ms,
            "device_busy_ms": busy,
            "device_idle_share": max(0.0, 1.0 - busy / frame_ms),
            "device_events_per_frame": len(dev) / frames}


if __name__ == "__main__":
    raise SystemExit(main())

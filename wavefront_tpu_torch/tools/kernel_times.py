"""Per-launch times of the port's render-path kernels, of the K7 row
gather and of the K4 histogram's calls, and the headline frame's device
time, to compare two trees of the port on one card.

    python wavefront_tpu_torch/tools/kernel_times.py [--root DIR]
        [--kernels K [K ...]] [--frames F] [--lamps L] [--reps N] [--sass]

DIR is a checkout whose `wavefront_tpu_torch` package is timed (default:
the one this file belongs to); it builds its own kernels under DIR.  Run
the file as a script: under `python -m` the package of the current
directory is imported before DIR can be put first, and the tool stops.

`--kernels` picks what is timed (default: trace shade), each kernel run
back to back between CUDA events:

  trace, shade  the tracer (K1) and the fused shade (K2) on the headline
                scene (1920x1080), on the bounce-0 rays sorted as the
                renderer sorts them and on the bounce-1 rays the shade
                makes from them, `reps` launches each; one line a bounce.
                With `--lamps L` the scene also holds the first L lamp
                voxels of the general frame's lattice (six light prims
                each; up to 41 keep the set dense), to time the shade at
                a larger light set.
  shade_bf16    the fused shade's bf16 color build on the same rays, tp in
                bfloat16 (a tree that has the build).
  texel         the texel fetch (K3) on the (tex, u, v) that the general
                frame's (`headline.general_setup`) first bounce hands it,
                `reps` launches.
  loop_probe    K5's onehot forms at the shape `chip_smoke.py`'s
                `probe_check` times: 264 groups of 16 rows, 64 iterations,
                a 64-row table (and an 8-row one, 256 iterations), `reps`
                launches each.
  extract_cur   K6's whole-scene read: 264 groups of 8 rows, 256
                iterations, a 160x160 table of 6 channels, lanes spread
                over it.
  extract_win   K6's window read: 264 groups of 8 rows, 256 iterations,
                25 windows of 8 channels, each group's lanes within 32
                voxels.
  row_gather    K7's `row_gather_sum` at R = 4096, reps 1 (one gather a
                launch: its time is the wrapper's host path), over
                GATHER_CALLS calls, beside `torch.gather` on the same
                table and indices; also the host clock's microseconds a
                call of each.
  radix         K4 at the headline's 2,073,600 keys, seeded (uniform
                over all 32 bits) and the headline frame's bounce-0
                coherence keys (their low 32 bits): one digit
                (`digit_histogram`, shift 0), one read of four
                (`digit_histograms4`), and `radix_hist` with `one_read`
                and in four passes; per call the wall ms (CUDA events
                over `reps` calls back to back, so the host's path
                counts where it is the longer), the device ms of every
                device operation the call makes (`torch.profiler`),
                their number, and the device ms of the histogram kernel
                alone (`*_kernel_ms`).  Every call is one that earlier
                trees of the port have too, so a tree and its parent can
                be timed in turns.

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
B, A).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

KERNELS = ("trace", "shade", "shade_bf16", "texel", "loop_probe",
           "extract_cur", "extract_win", "row_gather", "radix")
GATHER_ROWS = 4096
GATHER_CALLS = 1000


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

    def emit(row):
        print(json.dumps({"root": root, **row, "card": name,
                          "power_limit": limit}), flush=True)

    if {"trace", "shade", "shade_bf16"} & set(args.kernels):
        for row in trace_shade_rows(args):
            emit(row)
    if "texel" in args.kernels:
        emit(texel_row(args.reps))
    for kernel in ("loop_probe", "extract_cur", "extract_win"):
        if kernel in args.kernels:
            emit(probe_row(kernel, args.reps))
    if "row_gather" in args.kernels:
        emit(gather_row())
    if "radix" in args.kernels:
        for row in radix_rows(args.reps):
            emit(row)
    if args.frames:
        emit(frame_row(args.frames, args.blocks))
    if args.sass:
        emit(shade_sass_row())
    return 0


def trace_shade_rows(args):
    import torch

    from wavefront_tpu_torch.core.config import WorldSettings
    from wavefront_tpu_torch.core.vec3 import V3
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
    from wavefront_tpu_torch.render.renderer import coherence_sort
    from wavefront_tpu_torch.render.scene import VoxelScene
    from wavefront_tpu_torch.render.wavefront import raygen_soa
    from wavefront_tpu_torch.tools._timing import time_ms
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
        pa, pb, t = window_trace(arrays, o, d, events)
        args_ = (tables, arrays.grid_origin, o, d, pa, pb, t, tp, rad, rid,
                 b, b, arrays.lights.num_prims)
        row = {
            "bounce": b, "rays": n,
            "light_prims": int(arrays.lights.num_prims),
            "light_nodes": tables.m_nodes,
            "alive": int(((d.x != 0) | (d.y != 0) | (d.z != 0)).sum())}
        if "trace" in args.kernels:
            row["window_trace_ms"] = time_ms(
                lambda: window_trace(arrays, o, d, events), args.reps)
        if "shade" in args.kernels:
            row["shade_ms"] = time_ms(
                lambda: shade_pass(*args_, nee_type=1), args.reps)
        if "shade_bf16" in args.kernels:
            args16 = args_[:7] + (tp.map(lambda c: c.to(torch.bfloat16)),) \
                + args_[8:]
            row["shade_bf16_ms"] = time_ms(
                lambda: shade_pass(*args16, nee_type=1, color_bf16=True),
                args.reps)
        yield row
        o, d, tp, rad = (V3(*(c.contiguous() for c in v))
                         for v in shade_pass(*args_, nee_type=1))


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
    from wavefront_tpu_torch.tools._timing import time_ms

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
    return {"kernel": "texel", "rays": int(tex.shape[0]),
            "channels": list(chans),
            "texel_ms": time_ms(
                lambda: texel_fetch(atlas, tex, u, v, channels=chans), reps)}


def probe_row(kernel: str, reps: int) -> dict:
    import numpy as np
    import torch

    from wavefront_tpu_torch.kernels import extract_probe, loop_probe
    from wavefront_tpu_torch.tools import roofline
    from wavefront_tpu_torch.tools._timing import FILL_GROUPS, time_ms

    rng = np.random.default_rng(5)

    def i32(a):
        return torch.as_tensor(a.astype(np.int32), device="cuda")

    def u8(shape):
        return torch.as_tensor(rng.integers(0, 255, shape).astype(np.uint8),
                               device="cuda")

    row = {"kernel": kernel, "groups": FILL_GROUPS, "reps": reps}
    if kernel == "loop_probe":
        shape = (FILL_GROUPS, 16, 128)
        state = (i32(rng.integers(0, 100, shape)),
                 torch.zeros(shape, dtype=torch.int32, device="cuda"))
        row["rows"] = 16
        for nr, iters in ((64, 64), (8, 256)):
            table = u8((nr, 128))
            for where in ("smem", "ldg", "const"):
                row[f"onehot_{where}_{nr}_ms"] = time_ms(
                    lambda: loop_probe.loop_probe(
                        f"onehot_{where}", state, table, iters), reps)
            row[f"iters_{nr}"] = iters
    else:
        # the lanes of roofline's rows: uniform over the scene, or each
        # group within 32 voxels of its own base
        row.update(rows=8, iters=256)
        if kernel == "extract_cur":
            table = u8((6, 160, 160))
            cx, cz = roofline._lanes(rng, FILL_GROUPS, 8, 160, 160)
            row["ms"] = time_ms(lambda: extract_probe.extract_cur(
                table, cx, cz, 256), reps)
        else:
            tw = u8((25, 64, 128))
            cx, cz = roofline._lanes(rng, FILL_GROUPS, 8, 160, 160,
                                     roofline.SPREAD)
            row["ms"] = time_ms(lambda: extract_probe.extract_win(
                tw, cx, cz, 256, 5, 5), reps)
    return row


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
    return {"kernel": "row_gather", "rows": GATHER_ROWS, "reps": 1,
            "calls": GATHER_CALLS,
            "row_gather_ms": time_ms(k7, GATHER_CALLS),
            "torch_gather_ms": time_ms(lib, GATHER_CALLS),
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
        row = {"kernel": "radix", "keys": name, "n": int(keys.shape[0]),
               "reps": reps}
        for call, fn in calls.items():
            row[f"{call}_ms"] = time_ms(lambda: fn(keys), reps)
            (row[f"{call}_device_ms"], row[f"{call}_device_ops"],
             row[f"{call}_kernel_ms"]) = radix_device(lambda: fn(keys), reps)
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

"""The cost of the pieces of a tracer event on the card, and of the event
itself.

Counterpart of `tools/event_lab.py`.  The loop probes
(`kernels/loop_probe`) carry lanes through a long dependent loop of one
small body; the per-iteration cost is the slope between two iteration
counts of one launch.  Sections (`--only`):

  support  the five primitive kernels (int16 and int8 compares, a bf16
           multiply, a per-lane row pick and a lane roll by shuffles)
           against their plain versions: right, or the lab stops
  issue    64 chained int32 adds per iteration (128 dependent integer
           operations: an XOR with a hidden zero follows each add, or the
           assembler merges the adds), groups of 8, 16, 32 rows
  onehot   the table lookup s = sum_r table[r, code], 64 and 8 rows, with
           the table in shared, global (__ldg) and constant memory
  zsel     the pick of 1 row in 8 per channel: select tree, local-memory
           array, shared-memory row
  event    the tracer kernel's own cost per step: rays that march an
           all-air grid and outlast the budget, traced at two budgets
           (every ray reports `truncated`), the slope taken per ray-step.
           Fine crossings on an aux grid with its distances at 0 (no
           skip), 160x32x160 and 416x96x416, rays in coherence order and
           shuffled (every ray marches the same count, so the two differ
           by where their loads fall); skip steps on a 416x96x416 field
           of distance 2 everywhere (each skip lands a voxel or two on);
           the headline frame's bounce-1 rays, whose time per step against
           the uniform rows is what warps of unequal marches cost; and the
           machine instructions of one fine crossing of the kernel's march
           loop (`cuobjdump -sass`), to set beside the card's issue rate

Loop rows come for one group and for enough groups to fill the card.
`--tracer-library` counts the march loop of another build of the tracer
(an older checkout's `build/wavefront_tpu_torch/libwindow_trace_*.so`)
by the same rule, and prints that row alone.

    python -m wavefront_tpu_torch.tools.event_lab [--only support,issue,...]
    python -m wavefront_tpu_torch.tools.event_lab --tracer-library LIB
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess

import numpy as np
import torch

from wavefront_tpu_torch.core.vec3 import V3
from wavefront_tpu_torch.headline import (
    ASSETS,
    HEADLINE_RAYS,
    headline_setup,
)
from wavefront_tpu_torch.kernels import _build
from wavefront_tpu_torch.kernels import loop_probe as lp
from wavefront_tpu_torch.kernels.shade import prep_shade_tables, shade_pass
from wavefront_tpu_torch.kernels.window_trace import (
    auto_events,
    coherence_key,
    window_trace,
)
from wavefront_tpu_torch.render.intersect import (
    CLASS_TRANSLUCENT,
    CLASS_TRANSPARENT,
    TRUNCATED_BIT,
    trace_plain,
)
from wavefront_tpu_torch.render.renderer import coherence_sort
from wavefront_tpu_torch.render.scene import VoxelScene
from wavefront_tpu_torch.render.wavefront import raygen_soa
from wavefront_tpu_torch.tools._timing import (
    FILL_GROUPS,
    emit,
    require_card,
    time_ms,
    time_slope,
)
from wavefront_tpu_torch.world.blocks import BlockRegistry

SECTIONS = ("support", "issue", "onehot", "zsel", "event")

# (lo, hi) iteration counts per body: long enough that the slope stands
# clear of launch noise, short enough that the slowest form stays under a
# few hundred ms at FILL_GROUPS
ITERS = {"issue": (512, 4096), "onehot64": (64, 512), "onehot8": (256, 2048),
         "onehot_const64": (16, 64), "onehot_const8": (32, 256),
         "zsel": (256, 2048)}


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


def support() -> dict:
    """Each primitive kernel against its plain version: {name: "ok"}; a
    kernel that disagrees raises."""
    rng = np.random.default_rng(0)
    a = rng.integers(-30000, 30000, (128, 128))
    row = np.arange(128)[:, None]
    a[:, ::5], a[:, 1::5], a[:, 2::5] = row, row + 65536, row + 256
    a = torch.as_tensor(a.astype(np.int32), device="cuda")
    f = torch.as_tensor((rng.random((8, 128)) * 1000 - 500).astype(
        np.float32), device="cuda")
    idx = torch.as_tensor(rng.integers(-20, 20, (8, 128)).astype(np.int32),
                          device="cuda")
    out = {}
    for name in lp.PRIMITIVES:
        args = {"bf16_mul": (a.clamp(-30000, 30000),),   # square in int32
                "row_pick": (f, idx), "lane_roll": (f,)}.get(name, (a,))
        if not torch.equal(lp.primitive(name, *args),
                           lp.primitive_plain(name, *args)):
            raise AssertionError(f"primitive {name} disagrees with its "
                                 "plain version")
        out[name] = "ok"
    return out


def _loop_row(name, variant, extra, groups, rows, lo, hi, per_iter_ops=1):
    rng = np.random.default_rng(1)
    shape = (groups, rows, 128)
    state = (torch.as_tensor(rng.integers(0, 100, shape).astype(np.int32),
                             device="cuda"),)
    if variant != "issue":
        state += (torch.zeros(shape, dtype=torch.int32, device="cuda"),)
    per_iter = time_slope(
        lambda iters: (lambda: lp.loop_probe(variant, state, extra, iters)),
        lo, hi)
    return {"row": name, "groups": groups, "rows": rows,
            "ns_per_iter": per_iter * 1e6,
            "ns_per_lane_iter": per_iter * 1e6 / (groups * rows * 128),
            "ns_per_lane_op": per_iter * 1e6 / (groups * rows * 128)
            / per_iter_ops, "iters": [lo, hi]}


def loop_rows(sections, rows: int = 16) -> list:
    """The issue, onehot and zsel rows, measured on the card."""
    rng = np.random.default_rng(2)
    out = []
    for groups in (1, FILL_GROUPS):
        if "issue" in sections:
            for r in (8, 16, 32):
                out.append(_loop_row(f"issue_rows{r}", "issue", None, groups,
                                     r, *ITERS["issue"],
                                     per_iter_ops=lp.ISSUE_OPS))
        if "onehot" in sections:
            for nr in (64, 8):
                table = torch.as_tensor(rng.integers(0, 255, (nr, 128)).astype(
                    np.uint8), device="cuda")
                for where in ("smem", "ldg", "const"):
                    key = ("onehot_const" if where == "const" else "onehot") \
                        + str(nr)
                    out.append(_loop_row(
                        f"onehot_{where}_{nr}", f"onehot_{where}", table,
                        groups, rows, *ITERS[key], per_iter_ops=nr))
        if "zsel" in sections:
            offsets = torch.as_tensor(rng.integers(0, 255, (8, 8)).astype(
                np.int32), device="cuda")
            for how in ("tree", "local", "smem"):
                out.append(_loop_row(
                    f"zsel_{how}", f"zsel_{how}", offsets, groups, rows,
                    *ITERS["zsel"], per_iter_ops=lp.ZSEL_CHANNELS))
    return out


def _air_scene(gx, gy, gz, dist: int):
    """An all-air grid whose aux grid holds distance `dist` everywhere: 0
    marches by fine crossings, >= 2 by skips of radius dist-1."""
    registry = BlockRegistry.load(ASSETS)
    grid = np.full((gx, gy, gz), registry.air, np.uint8)
    arrays = VoxelScene(registry, grid, (0, 0, 0), device="cuda").get_arrays()
    air = CLASS_TRANSPARENT | CLASS_TRANSLUCENT
    return arrays._replace(aux_grid=torch.full_like(
        arrays.aux_grid, air | (dist << 2)))


def _uniform_event_rows(gx, gy, gz, lo, hi, n=HEADLINE_RAYS, dist=0,
                        which=("sorted", "shuffled")) -> list:
    """Near-horizontal rays from the middle of an all-air grid, in every
    azimuth: `hi` steps (fine crossings, or skips when dist >= 2) leave
    each ray inside the grid, so each marches exactly its budget."""
    arrays = _air_scene(gx, gy, gz, dist)
    rng = np.random.default_rng(3)
    org = np.array([gx, gy, gz]) / 2.0 + rng.uniform(-8.0, 8.0, (n, 3))
    az = rng.uniform(0.0, 2.0 * np.pi, n)
    dirs = np.stack([np.cos(az), rng.uniform(-0.02, 0.02, n), np.sin(az)], 1)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)

    def v3(a, order=None):
        cols = (torch.as_tensor(a[:, i].astype(np.float32), device="cuda")
                for i in range(3))
        return V3(*(c if order is None else c[order].contiguous()
                    for c in cols))

    o, d = v3(org), v3(dirs)
    key = coherence_key(o.x, o.y, o.z, d.x, d.y, d.z, gx, gy, gz)
    orders = {"sorted": torch.sort(key, stable=True).indices,
              "shuffled": torch.as_tensor(rng.permutation(n), device="cuda")}
    kind = "skip" if dist >= 2 else "event"
    out = []
    for name in which:
        order = orders[name]
        oo, dd = v3(org, order), v3(dirs, order)
        for budget in (lo, hi):
            pa = window_trace(arrays, oo, dd, budget)[0]
            if int(((pa >> TRUNCATED_BIT) & 1).sum()) != n:
                raise AssertionError(
                    f"{kind} rows: not every ray outlasts {budget} steps")
        per_step = time_slope(
            lambda ev: (lambda: window_trace(arrays, oo, dd, ev)), lo, hi)
        out.append({"row": f"{kind}_{gx}x{gy}x{gz}_{name}", "rays": n,
                    "events": [lo, hi], "aux_distance": dist,
                    "ns_per_ray_step": per_step * 1e6 / n,
                    "ms_per_step_of_all_rays": per_step})
    return out


def _headline_event_row() -> dict:
    """The tracer on the headline frame's bounce-1 rays (after the
    coherence sort, as the renderer hands them over): its time over the
    steps these rays take (fine crossings and skips, counted by the plain
    version), beside the crossings an unskipped march would make."""
    scene, settings, basis, _ = headline_setup(1920, 1080, 4, device="cuda")
    arrays = scene.get_arrays()
    tables = prep_shade_tables(arrays.atlas_packed, arrays.lights)
    w, h = settings.render_width, settings.render_height
    n = w * h
    o, d, rid = raygen_soa(basis.eye, basis.front, basis.right, basis.up,
                           w, h, device="cuda")
    tp = V3(*(torch.ones(n, device="cuda") for _ in range(3)))
    rad = V3(*(torch.zeros(n, device="cuda") for _ in range(3)))
    events = auto_events(*arrays.grid.shape)
    o, d, tp, rad, rid = coherence_sort(arrays, o, d, tp, rad, rid)
    pa, pb, t = window_trace(arrays, o, d, events)
    o, d, tp, rad = shade_pass(tables, arrays.grid_origin, o, d, pa, pb, t,
                               tp, rad, rid, 0, 0, arrays.lights.num_prims,
                               nee_type=1)
    o, d, tp, rad, rid = coherence_sort(arrays, o, d, tp, rad, rid)
    pa, pb, t = window_trace(arrays, o, d, events)
    crossings = dda_steps(arrays, o, d, pa, t)
    stats = {}
    trace_plain(arrays, o, d, events, stats=stats)
    steps = stats["fine"] + stats["skips"]
    # back to back, so that the wrapper's host time hides behind the
    # kernel before it (a launch timed alone would carry it)
    ms = time_ms(lambda: window_trace(arrays, o, d, events), 10)
    alive = int(((d.x != 0) | (d.y != 0) | (d.z != 0)).sum())
    return {"row": "event_headline_bounce1", "rays": n, "alive": alive,
            "fine": stats["fine"], "skips": stats["skips"],
            "crossings": crossings, "ms": ms,
            "ns_per_ray_step": ms * 1e6 / steps}


def _function_code(library: str, kernel: str) -> dict:
    """{address: instruction} of the first function of `library` whose
    mangled name matches the regular expression `kernel`, read with the
    toolkit's `cuobjdump -sass`."""
    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", library], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    state, code = "before", {}
    for line in sass.splitlines():
        if "Function :" in line:
            if state == "inside":
                break
            if re.search(kernel, line):
                state = "inside"
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if state == "inside" and m:
            code[int(m.group(1), 16)] = m.group(2).strip()
    return code


def _outer_loop(code: dict, what: str) -> tuple:
    """(head, tail) of the largest backward branch in `code`."""
    head, tail = None, None
    for addr, text in code.items():
        target = re.search(r"\bBRA\s+(?:`\()?(0x[0-9a-f]+)", text)
        if target and int(target.group(1), 16) < addr and (
                tail is None or addr - int(target.group(1), 16)
                > tail - head):
            head, tail = int(target.group(1), 16), addr
    if head is None:
        raise RuntimeError(f"{what}: no loop found in the kernel's machine "
                           "code")
    return head, tail


# bytes a shared load moves by its opcode's width suffix (no suffix: 4)
_LDS_BYTES = {"U8": 1, "S8": 1, "U16": 2, "S16": 2, "64": 8, "128": 16}


def probe_loop_sass(lib: str, kernel: str) -> dict:
    """The machine code of the dependent loop of a probe kernel: the
    largest backward branch of the function of `csrc/<lib>.cu` whose
    mangled name matches `kernel` (this tree's build).  Returns
    {"instructions": the loop's span, "shared_loads": LDS instructions in
    it, "shared_load_bytes": their widths summed, "shared_bank_bytes":
    the same with each load counted as at least one 4-byte bank slot,
    "dp4a": IDP.4A
    instructions, "global_loads": LDG, "constant_loads": LDC}."""
    code = _function_code(_build.library_path(lib), kernel)
    head, tail = _outer_loop(code, f"probe_loop_sass {kernel}")
    out = {"instructions": 0, "shared_loads": 0, "shared_load_bytes": 0,
           "shared_bank_bytes": 0, "dp4a": 0, "global_loads": 0, "constant_loads": 0}
    for addr, text in code.items():
        if not head <= addr <= tail:
            continue
        out["instructions"] += 1
        op = re.sub(r"^@!?U?P\w+\s+", "", text).split()[0]
        name, _, suffix = op.partition(".")
        if name == "LDS":
            out["shared_loads"] += 1
            width = [_LDS_BYTES[x] for x in suffix.split(".")
                     if x in _LDS_BYTES]
            out["shared_load_bytes"] += width[0] if width else 4
            out["shared_bank_bytes"] += max(4, width[0] if width else 4)
        out["dp4a"] += name == "IDP"
        out["global_loads"] += name == "LDG"
        out["constant_loads"] += name == "LDC"
    return out


def march_loop_instructions(library: str | None = None) -> dict:
    """Machine instructions of the tracer kernel's march loop, read from
    a built library (`library`, or this tree's, built on first use) with
    the toolkit's `cuobjdump -sass`.

    The loop is the span of the largest backward branch in
    `trace_kernel`; its head is that branch's target.  Inside it, the
    control-flow graph of the instructions (fall-through, branch targets,
    both for a predicated branch) is searched for the shortest way from
    the head back to it: a step that neither hits nor leaves the grid.
    A skip step recomputes three crossing times and the flat index where
    a fine crossing recomputes one and adds to the index, so the shortest
    cycle is the fine crossing.  Returns {"fine_crossing": its
    instructions, "loop_span": the whole loop's, fine and skip paths
    together}."""
    code = _function_code(library or _build.library_path("window_trace"),
                          "trace_kernel")
    head, tail = _outer_loop(code, "march_loop_instructions")
    step = 16

    def successors(addr):
        text = code[addr]
        predicated = text.startswith("@")
        target = re.search(r"\bBRA\s+(?:`\()?(0x[0-9a-f]+)", text)
        out = []
        if target:
            out.append(int(target.group(1), 16))
        elif re.search(r"\b(EXIT|RET|BRX|JMX)\b", text):
            pass
        else:
            out.append(addr + step)
        if predicated and (target or "EXIT" in text or "RET" in text):
            out.append(addr + step)
        return [a for a in out if head <= a <= tail and a in code]

    # breadth-first: instructions executed from the head until it recurs
    dist, frontier, fine = {head: 1}, [head], None
    while frontier and fine is None:
        nxt = []
        for a in frontier:
            for b in successors(a):
                if b == head:
                    fine = dist[a]
                    break
                if b not in dist:
                    dist[b] = dist[a] + 1
                    nxt.append(b)
            if fine is not None:
                break
        frontier = nxt
    if fine is None:
        raise RuntimeError("march_loop_instructions: no path from the loop "
                           "head back to it")
    return {"fine_crossing": fine, "loop_span": (tail - head) // step + 1}


def march_loop_row(library: str | None = None) -> dict:
    loop = march_loop_instructions(library)
    return {"row": "event_march_loop",
            "library": library or "this tree",
            "instructions_per_fine_crossing": loop["fine_crossing"],
            "loop_span_instructions": loop["loop_span"]}


def event_rows() -> list:
    """The tracer's per-crossing rows, measured on the card."""
    return (_uniform_event_rows(160, 32, 160, 16, 64)
            + _uniform_event_rows(416, 96, 416, 32, 192)
            + _uniform_event_rows(416, 96, 416, 16, 64, dist=2,
                                  which=("sorted",))
            + [_headline_event_row(), march_loop_row()])


def rows(only=None, group_rows: int = 16) -> list:
    """The lab's rows for the sections in `only` (all when None)."""
    sections = set(SECTIONS if only is None else only)
    unknown = sections - set(SECTIONS)
    if unknown:
        raise ValueError(f"event_lab: no section {sorted(unknown)}; "
                         f"the sections are {SECTIONS}")
    out = []
    if "support" in sections:
        out.append({"row": "support", **support()})
    out += loop_rows(sections, group_rows)
    if "event" in sections:
        out += event_rows()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", type=str, default="",
                    help="comma-separated sections: " + ",".join(SECTIONS))
    ap.add_argument("--rows", type=int, default=16,
                    help="rows of 128 lanes in a group of the onehot and "
                         "zsel rows (8, 16 or 32)")
    ap.add_argument("--tracer-library", default=None,
                    help="print only the march-loop row of this built "
                         "tracer library")
    args = ap.parse_args(argv)
    only = [s for s in args.only.split(",") if s] or None
    require_card()
    if args.tracer_library:
        emit([march_loop_row(os.path.abspath(args.tracer_library))])
        return 0
    emit(rows(only, args.rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

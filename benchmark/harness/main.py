"""One run of one cell: set-up, the measured window, the check, one line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Each run is a new process.  It builds the cell's system with its
configuration's `build` (kernels built or loaded, the scene made), runs
the traffic's warm images, collects garbage, and then runs the closed
loop of the traffic mix for `--seconds` (with `--trace 1`, for at most
TRACE_SECONDS inside one profiler session).  An image is what the
program hands the host: one frame, or the mean of `frames_per_image`
frames where the traffic asks for it.  After the window it reads the
device's memory peak, frees the program's state, runs the reference
over a seeded sample of the window's images and prints the check's
numbers beside their limits, on the last lines of standard error and
under the result's last key.  The last line of standard output is the
result.

An image whose audit reports a truncated ray or an NEE overflow, or
whose call raises, counts in `failed`, and a run with a failed image is
not correct.  The run exits nonzero, with no result, without a CUDA card
(or with fewer than the cell asks for), and when a module whose
top-level name is jax, jaxlib, flax or wavefront_tpu is loaded once the
window has closed.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import random
import sys
import time

import numpy as np

from benchmark.harness import check
from benchmark.harness import device as devinfo
from benchmark.harness import spec as specmod
from benchmark.harness.tracing import FRAME_SPAN, Session, Spans, Trace
from benchmark.harness.window import Window

TRACE_SECONDS = 4.0
MAX_FAILED_IN_A_ROW = 20


class Traffic:
    """The one generator: a traffic file's parameters and a seed give
    each image's view (yaw) and first frame count."""

    def __init__(self, params: dict, cfg: dict, seed: int):
        r = random.Random(seed)
        self.step = float(params["yaw_step"])
        self.k = int(params["frames_per_image"])
        self.yaw0 = float(cfg["camera"]["yaw"]) \
            + float(params["yaw_jitter"]) * r.random()
        # frame counts stay below 2^32 through any window
        self.fc0 = r.randrange(2**32 - 2**26)

    def view(self, i: int):
        """(yaw, first frame count, frames) of image i; i < 0 are the
        warm images."""
        return self.yaw0 + self.step * i, self.fc0 + self.k * i, self.k


class Keep:
    """The images the check will judge, drawn from the seed as they
    come: a uniform sample of `check_images` images of the window
    (reservoir sampling), each with its own seeded `check_pixels`.  Only
    a kept image's sampled pixels are copied out, so no image outlives
    its frame."""

    def __init__(self, traffic: dict, cfg: dict, seed: int):
        n = cfg["width"] * cfg["height"]
        rng = np.random.default_rng([seed % 2**32, seed // 2**32 % 2**32, 7])
        self.size = int(traffic["check_images"])
        self.pix = [rng.choice(n, traffic["check_pixels"], replace=False)
                    for _ in range(self.size)]
        self.rng = random.Random(seed ^ 0x5EED)
        self.slots = [None] * self.size

    def offer(self, i: int, img, **rec) -> None:
        """Image i of the window (on the host)."""
        j = i if i < self.size else self.rng.randrange(i + 1)
        if j < self.size:
            vals = np.asarray(img).reshape(-1, 3)[self.pix[j]]
            self.slots[j] = {**rec, "pix": self.pix[j], "vals": vals}

    @property
    def kept(self) -> list:
        return [f for f in self.slots if f is not None]


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run_window(system, traffic: Traffic, seconds: float, keep: Keep,
               spans=None):
    """The closed loop: (window, failed, kept images, session).  With
    `spans` the window runs inside one profiler session, each image in
    a span of its own."""
    ends = []
    failed = in_a_row = 0
    session = None
    if spans is not None:
        from torch.profiler import record_function

        session = Session()
        session.open()
        for rec in spans.records.values():
            rec.clear()
    t_open = time.perf_counter()
    i = 0
    while True:
        yaw, fc, k = traffic.view(i)
        try:
            if session is not None:
                with record_function(FRAME_SPAN):
                    img, aux = system.frame(yaw, fc, k)
            else:
                img, aux = system.frame(yaw, fc, k)
            ok = not (aux.get("truncated") or aux.get("nee_overflow"))
        except Exception as e:  # a frame that raises is a failed frame
            print(f"image {i} raised: {e!r}", file=sys.stderr)
            img, ok = None, False
        t = time.perf_counter()
        ends.append(t)
        if ok:
            in_a_row = 0
            keep.offer(i, img, yaw=yaw, fc=fc, k=k)
        else:
            failed += 1
            in_a_row += 1
        i += 1
        if t - t_open >= seconds or in_a_row >= MAX_FAILED_IN_A_ROW:
            break
    if session is not None:
        session.close()
    return Window(t_open, ends, 0.0, traffic.k), failed, keep.kept, session


def run(args, root: str, t_start: float, device: str = "cuda",
        sizes=None, traffic=None, fault=None, steady: bool = False) -> dict:
    """One run; returns the result dict.  `device`, `sizes` and
    `traffic` (overrides of the configuration's and the traffic's keys)
    and `fault` (a callable given the system, which may break it) serve
    the tests on the CPU; `steady` sets the host allocator for the warm
    images and the window (`device.steady_allocator`), as a run does."""
    cell = specmod.load_cell(args.workload, root)
    cell.config = {**cell.config, **(sizes or {})}
    cell.traffic = {**cell.traffic, **(traffic or {})}
    seed = args.seed % (1 << 63)
    gen = Traffic(cell.traffic, cell.config, seed)
    phases = {"start": time.perf_counter() - t_start}
    system = cell.build.build(cell.config, dict(cell.traffic["settings"]),
                              device, phases)
    if fault is not None:
        fault(system)
    spans = layer = None
    if args.trace:
        spans = Spans()
        layer = []
        for m in cell.per_layer:
            mod = specmod.reader("metrics", m["name"], root)
            install = getattr(mod, "install", None)
            if install is None or install(spans, system):
                layer.append((m, mod))
    # the host allocator's settings hold from the warm images on (not
    # for the CUDA start, whose large allocations want fresh mappings)
    allocator = devinfo.steady_allocator() if steady else None
    t = time.perf_counter()
    for i in range(-int(cell.traffic["warm_images"]), 0):
        system.frame(*gen.view(i))
    phases["warm"] = time.perf_counter() - t
    gc.collect()
    gc.freeze()
    seconds = min(args.seconds, TRACE_SECONDS) if args.trace \
        else args.seconds
    keep = Keep(cell.traffic, cell.config, seed)
    win, failed, kept, session = run_window(system, gen, seconds, keep,
                                            spans)
    win.setup_s = win.t_open - t_start
    dev = devinfo.after_window(device, cell.chips)
    result = {"phases": phases, "setup_s": win.setup_s,
              "steady_allocator": allocator}
    if args.trace:
        tr = Trace(session.prof, win.frames, dict(spans.records),
                   spans.installed, session.launched)
        del session
        if tr.lost:
            print(f"trace: kernel records lost: {tr.lost}", file=sys.stderr)
        metrics = {}
        for m, mod in layer:
            v = mod.read(tr)
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
        result["breakdown"] = tr.breakdown()
        result["trace_kinds"] = dict(tr.kinds)
        result["trace_launched"] = tr.launched
        result["trace_lost"] = tr.lost
        del tr
    else:
        metrics = {}
        for m in cell.end_to_end:
            v = specmod.reader("end_to_end", m["name"], root).read(win)
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    # the program's state goes before the reference runs
    del system, spans, layer
    gc.collect()
    devinfo.free(device)
    t = time.perf_counter()
    numbers = check.compare(cell, kept, seed, device,
                            os.path.join(root, "assets"))
    check_s = time.perf_counter() - t
    limits = cell.limits
    compared = {n: {"value": v, "limit": limits.get(n)}
                for n, v in numbers.items()}
    correct = bool(kept) and failed == 0 and all(
        c["limit"] is not None and c["value"] <= c["limit"]
        for c in compared.values())
    result.update({
        "correct": correct, "attempted": win.images, "failed": failed,
        "metrics": metrics, "device": dev, "check_s": check_s,
        "frames_checked": len(kept), "check": compared})
    return result


def emit(result: dict) -> None:
    """The check's numbers on the last lines of standard error, then the
    result as the last line of standard output, the check last in it."""
    for n, c in result["check"].items():
        print(f"check {n}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"check correct: {result['correct']} (attempted "
          f"{result['attempted']}, failed {result['failed']})",
          file=sys.stderr)
    sys.stderr.flush()
    line = {k: result[k] for k in ("correct", "attempted", "failed",
                                   "metrics", "device")}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["check"] = result["check"]
    print(json.dumps(line), flush=True)


def main(argv=None, t_start=None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    root = specmod.ROOT
    cell = specmod.load_cell(args.workload, root)
    devinfo.require_cards(cell.chips)
    print(json.dumps({"run": {"workload": args.workload, "seed": args.seed,
                              "seconds": args.seconds, "trace": args.trace},
                      **devinfo.versions()}), file=sys.stderr, flush=True)
    result = run(args, root, t_start, steady=True)
    found = devinfo.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {sorted(found)}", file=sys.stderr)
        return 3
    print(json.dumps({"phases": result["phases"],
                      "setup_s": result["setup_s"],
                      "check_s": result["check_s"],
                      "frames_checked": result["frames_checked"],
                      "steady_allocator": result["steady_allocator"],
                      **{k: result[k] for k in (
                          "trace_kinds", "trace_launched", "trace_lost")
                         if k in result},
                      **devinfo.describe_card()}), flush=True)
    emit(result)
    return 0

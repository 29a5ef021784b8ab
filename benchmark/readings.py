"""The readings that the check's limits are set from (not run by the
benchmark's own runs).

    python3 benchmark/readings.py --workload <cell> --seeds 1 2 ... \
        [--control-seeds 101 102 103] [--seconds 2]

In one process: the cell's system is built once, and for each seed a
short window of the cell's own traffic runs and the check's numbers are
computed, as a run computes them; then the control, the same system
built with the program's bfloat16 color pipeline (`shade_bf16`), the
nearest precision below the float32 the configuration states, runs the
control seeds.  One JSON line per window.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import check, device as devinfo  # noqa: E402
from benchmark.harness import spec as specmod  # noqa: E402
from benchmark.harness.main import Keep, Traffic, run_window  # noqa

CONTROL = {"shade_bf16": True}


def readings(cell, variant: str, overrides: dict, seeds, seconds: float,
             device: str, scene) -> list:
    rows = []
    phases = {}
    system = cell.build.build(cell.config,
                              {**cell.traffic["settings"], **overrides},
                              device, phases)
    for seed in seeds:
        gen = Traffic(cell.traffic, cell.config, seed)
        for i in range(-int(cell.traffic["warm_images"]), 0):
            system.frame(*gen.view(i))
        keep = Keep(cell.traffic, cell.config, seed)
        win, failed, kept, _ = run_window(system, gen, seconds, keep)
        t = time.perf_counter()
        numbers = check.compare(cell, kept, seed, device,
                                os.path.join(ROOT, "assets"), scene)
        row = {"workload": cell.name, "variant": variant, "seed": seed,
               "images": win.images, "failed": failed,
               "frame_ms": win.mean_ms(), "check_s": time.perf_counter() - t,
               "numbers": numbers}
        print(json.dumps(row), flush=True)
        rows.append(row)
    del system
    devinfo.free(device)
    return rows


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    cell = specmod.load_cell(args.workload, ROOT)
    devinfo.require_cards(cell.chips)
    device = "cuda"
    print(json.dumps({**devinfo.versions(), **devinfo.describe_card()}),
          flush=True)
    scene = cell.build.reference(cell.config, os.path.join(ROOT, "assets"),
                                 device)
    readings(cell, "program", {}, args.seeds, args.seconds, device, scene)
    if args.control_seeds:
        readings(cell, "control", CONTROL, args.control_seeds, args.seconds,
                 device, scene)


if __name__ == "__main__":
    main()

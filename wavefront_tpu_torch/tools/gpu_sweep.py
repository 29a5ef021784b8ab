"""Run the port's measurements in one queue: the parity gates, the
headline benchmark, the ladder and the occupancy survey.

Counterpart of `tools/tpu_sweep.py`, with its stages (`--stages`):

  gates   `gpu_parity` (the config-1 golden) and `gpu_parity --bench`
          (the headline program against the exhaustive plain march)
  bench   `python -m wavefront_tpu_torch.bench`
  ladder  `bench_ladder --configs ... --frames ...`
  occ     `occupancy` (K1's steps and lane occupancy)

It first asks `gpu_probe` once whether the card is up; down, it exits 2,
or with `--wait` asks again every 120 s.  Each stage's commands run as
subprocesses from the repository root, one after another, with the JAX
tool's time limits; their output goes to this process's.  After each
command one JSON line: the stage, the command, its exit code (None when
its time limit cut it) and its seconds.  It exits 1 when any command
failed.

    python -m wavefront_tpu_torch.tools.gpu_sweep [--stages gates bench \
        ladder] [--configs 1 ... 8] [--frames 5] [--wait] [--device cuda] \
        [--width W --height H]

`--width`/`--height` go to the stages that take them (`gpu_parity
--bench`, `bench`, `occupancy`).  Without a card it exits unless given
`--device cpu`, which asks no probe and hands `--device cpu` to every
stage.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from wavefront_tpu_torch.headline import REPO
from wavefront_tpu_torch.tools import _sweep
from wavefront_tpu_torch.tools._timing import emit

STAGES = ("gates", "bench", "ladder", "occ")
PROBE_LOG = os.path.join(REPO, "build", "gpu_sweep", "gpu_probe.jsonl")
# seconds between two probes with --wait
WAIT_S = 120


def probe(timeout: int = 90) -> bool:
    """True when `gpu_probe` reaches the card within `timeout` seconds."""
    os.makedirs(os.path.dirname(PROBE_LOG), exist_ok=True)
    try:
        r = subprocess.run(
            [sys.executable, "-m", "wavefront_tpu_torch.tools.gpu_probe",
             "--log", PROBE_LOG], cwd=REPO, timeout=timeout,
            capture_output=True, text=True)
        return r.returncode == 0
    except subprocess.TimeoutExpired:
        return False


def run(cmd: list, timeout: int):
    """Run `cmd` from the repository root: (exit code or None when its
    time limit cut it, seconds)."""
    print(f"=== {' '.join(cmd)}", file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    try:
        code = subprocess.run(cmd, cwd=REPO, timeout=timeout).returncode
    except subprocess.TimeoutExpired:
        code = None
    return code, time.perf_counter() - t0


def commands(stages, configs, frames: int, device: str, size=()) -> list:
    """(stage, command, time limit in s) of each command of `stages`, in
    the JAX tool's order."""
    py = [sys.executable, "-m"]
    dev = [] if device == "cuda" else ["--device", device]
    tool = "wavefront_tpu_torch.tools."
    out = []
    if "gates" in stages:
        out.append(("gates", py + [tool + "gpu_parity"] + dev, 1200))
        out.append(("gates", py + [tool + "gpu_parity", "--bench", *size]
                    + dev, 3600))
    if "bench" in stages:
        out.append(("bench", py + ["wavefront_tpu_torch.bench", *size] + dev,
                    3600))
    if "ladder" in stages:
        out.append(("ladder", py + [tool + "bench_ladder", "--configs",
                                    *map(str, configs), "--frames",
                                    str(frames)] + dev, 4 * 3600))
    if "occ" in stages:
        out.append(("occ", py + [tool + "occupancy", *size] + dev, 3600))
    return out


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--stages", nargs="+", default=["gates", "bench", "ladder"],
                   choices=STAGES)
    p.add_argument("--configs", type=int, nargs="+",
                   default=[1, 2, 3, 4, 5, 6, 7, 8])
    p.add_argument("--frames", type=int, default=5)
    p.add_argument("--wait", action="store_true",
                   help="probe every 120 s until the card answers")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda, or cpu for every stage's plain versions")
    args = p.parse_args(argv)
    dev = _sweep.device_of(args.device)
    if dev.type == "cuda":
        while not probe():
            if not args.wait:
                print(json.dumps({"stage": "probe", "card": "down"}),
                      flush=True)
                raise SystemExit(2)
            print(f"card down; probing again in {WAIT_S} s",
                  file=sys.stderr, flush=True)
            time.sleep(WAIT_S)
    size = []
    for flag, v in (("--width", args.width), ("--height", args.height)):
        if v is not None:
            size += [flag, str(v)]
    rows = []
    for stage, cmd, limit in commands(args.stages, args.configs,
                                      args.frames, dev.type, size):
        code, seconds = run(cmd, limit)
        rows += emit([{"stage": stage, "command": cmd[2:], "exit": code,
                       "seconds": seconds}], dev)
    if any(r["exit"] != 0 for r in rows):
        raise SystemExit(1)
    return rows


if __name__ == "__main__":
    main()

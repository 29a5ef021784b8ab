"""Sweep the bounce-sort schedule (`sort_bounces`) at the headline frame.

Counterpart of `tools/sort_sweep.py`: each row renders the headline
(`headline.headline_setup`: 1920x1080, 4 bounces, NEE, compaction) with
`sort_bounces=<schedule>`; None is the every-bounce sort.  A bounce left
out of the schedule traces its rays in the order of the last sort, and
its compaction bucket covers the last alive slot.  The images do not
depend on the schedule, so what a row buys is time: the sort and its
gathers it skips against what the stale order costs the tracer (K1) and
the fused shade (K2).

Each row: `frame_ms` (host clock over `--frames` frames, ended by a
synchronize), the sorts a frame, the trace audit's `truncated`, the
image's max |diff| against the `all` row's at one frame count (held to
1e-5, the bound of tests/test_golden.py's schedule test), and from
torch.profiler over 3 frames: device busy ms, `aten::sort` and
`aten::index` (the sort's gathers) ms, K1 and K2 ms a frame.  On the CPU
the device numbers are None.

    python -m wavefront_tpu_torch.tools.sort_sweep [--frames 3] \
        [--rows all b1 none] [--width 1920 --height 1080 --bounces 4] \
        [--device cuda]

Without a card it exits unless given `--device cpu`, which runs the
kernels' plain versions.
"""

from __future__ import annotations

import argparse

import torch

from wavefront_tpu_torch.headline import headline_setup
from wavefront_tpu_torch.render.renderer import Renderer
from wavefront_tpu_torch.tools import _sweep
from wavefront_tpu_torch.tools._timing import emit

SCHEDULES = [
    ("all", None),
    ("b1-b2", (1, 2)),
    ("b1-b3", (1, 3)),
    ("b1", (1,)),
    ("none", ()),
]
# the largest |diff| of a schedule's image from the every-bounce sort's
IMAGE_TOLERANCE = 1e-5


def sweep(scene, settings, basis, prefs, frames: int = 3,
          names=None) -> list:
    """The rows of the schedules named in `names` (all when None), on the
    scene's device."""
    dev = torch.device(scene.device)
    ref = Renderer(settings.replace(sort_bounces=None), device=dev).render(
        scene, basis, prefs, frame_count=1, as_numpy=False)
    sorting = settings.compaction or prefs.sort_type == 1
    out = []
    for name, sched in SCHEDULES:
        if names is not None and name not in names:
            continue
        s = settings.replace(sort_bounces=sched)
        r = Renderer(s, device=dev)
        row = {"row": name, "frame_ms": _sweep.time_frames(
            r, scene, basis, prefs, frames),
            "sort_bounces": None if sched is None else list(sched)}
        img, aux = r.render(scene, basis, prefs, frame_count=1,
                            as_numpy=False, with_aux=True)
        row["max_abs_diff"] = float((img - ref).abs().max())
        row["truncated"] = aux["truncated"]
        row["sorts"] = sum(sorting and (sched is None or b in sched)
                           for b in range(s.num_bounces))
        prof = _sweep.frame_profile(r, scene, basis, prefs)
        row["device_busy_ms"] = prof["device_busy_ms"]
        row["kernel_records"] = prof["kernel_records"]
        if prof["device_busy_ms"] is None:
            row.update(dict.fromkeys(("sort_ms", "gather_ms",
                                      "sort_gather_ms", "trace_ms",
                                      "shade_ms")))
        else:
            ops, kms = prof["device_ms_by_op"], prof["kernel_ms"]
            sort_ms = ops.get("aten::sort", 0.0)
            gather_ms = ops.get("aten::index", 0.0)
            row.update(sort_ms=sort_ms, gather_ms=gather_ms,
                       sort_gather_ms=sort_ms + gather_ms,
                       trace_ms=kms["window_trace"], shade_ms=kms["shade"])
        out.append(row)
    return out


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--frames", type=int, default=3)
    p.add_argument("--rows", nargs="+", default=None,
                   choices=[n for n, _ in SCHEDULES],
                   help="subset of schedule names to run")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--bounces", type=int, default=4)
    p.add_argument("--device", default="cuda",
                   help="cuda, or cpu for the kernels' plain versions")
    args = p.parse_args(argv)
    dev = _sweep.device_of(args.device)
    scene, settings, basis, prefs = headline_setup(
        args.width, args.height, args.bounces, device=dev)
    return emit(sweep(scene, settings, basis, prefs, args.frames, args.rows),
                dev)


if __name__ == "__main__":
    main()

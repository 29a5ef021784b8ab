"""One-session A/B of the fused shade against the general shade at the
headline frame.

Counterpart of `tools/fused_ab.py`: the headline (`headline.headline_setup`)
with `shade_fused` None (the fused shade kernel, K2) and False (the
general path: plain tensor stages around the texel kernel, K3), in one
process.  The row names are the JAX tool's: "fused" and "xla", the JAX
package's name for its unfused chain, which here is the general path.

Each row: `frame_ms` (host clock over `--frames` frames), device busy ms
and K1-K3 ms a frame (torch.profiler over 3 frames), and one frame's
device ms by stage (`_sweep.stage_times`); `shade_ms` is that frame less
its sort and tracer stages: the shade (K2 on the fused row, the general
stages around K3 on the other) with raygen, the buckets and the
restore.  Also the max |diff| between the two rows'
images at one frame count.

    python -m wavefront_tpu_torch.tools.fused_ab [--frames 3] \
        [--width 1920 --height 1080 --bounces 4] [--device cuda]

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

ARMS = (("fused", None), ("xla", False))


def ab(scene, settings, basis, prefs, frames: int = 3) -> list:
    dev = torch.device(scene.device)
    out, imgs = [], []
    for name, fused in ARMS:
        s = settings.replace(shade_fused=fused)
        r = Renderer(s, device=dev)
        row = {"row": name, "shade_fused": fused,
               "frame_ms": _sweep.time_frames(r, scene, basis, prefs,
                                              frames)}
        imgs.append(r.render(scene, basis, prefs, frame_count=1,
                             as_numpy=False))
        prof = _sweep.frame_profile(r, scene, basis, prefs)
        stages = _sweep.stage_times(scene, s, basis, prefs, 1)
        by = stages["ms_by_stage"]
        row.update(device_busy_ms=prof["device_busy_ms"],
                   kernel_ms=prof["kernel_ms"], stage_ms=by,
                   stage_frame_ms=stages["frame_ms"],
                   shade_ms=stages["frame_ms"] - sum(by.get(k, 0.0) for k in (
                       "bounce_sort_key", "coherence_sort", "window_trace")))
        out.append(row)
    diff = float((imgs[0] - imgs[1]).abs().max())
    for row in out:
        row["max_abs_diff"] = diff
    return out


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--frames", type=int, default=3)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--bounces", type=int, default=4)
    p.add_argument("--device", default="cuda",
                   help="cuda, or cpu for the kernels' plain versions")
    args = p.parse_args(argv)
    dev = _sweep.device_of(args.device)
    scene, settings, basis, prefs = headline_setup(
        args.width, args.height, args.bounces, device=dev)
    return emit(ab(scene, settings, basis, prefs, args.frames), dev)


if __name__ == "__main__":
    main()

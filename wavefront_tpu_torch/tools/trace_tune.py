"""Frame-level sweep of the tracer and sort settings the port honours, at
the headline frame.

Counterpart of `tools/trace_tune.py`: whole headline frames
(`headline.headline_setup`), one JSON line a combination of
  compaction     0 (no bounce sort, every ray traced each bounce) or 1
                 (the bounce sort, alive rays first, and the smallest of
                 n, n/2, n/4 that holds them);
  trace_skips    0 (K1 crosses every voxel boundary) or 1 (it skips
                 empty space through the aux grid's distances);
  trace_presort  0 (the sort keys on the reference's non-hoisted key) or
                 1 (on the tracer's coherence key);
  shade_bf16     0 or 1 (K2's bf16 color build), 0 by default;
with its `frame_ms` (host clock over `--frames` frames), device busy ms
(torch.profiler over 3 frames; None on the CPU), the trace audit's
`truncated`, and then the fastest combination with no truncated ray
(`best`).

The JAX tool's other knobs (`--tiles`, `--windows`, `--windows-hot`,
`--phases`, `--phase-events`, `--phases-at`, `--unroll`,
`--skip-strides`, `--wskips`) choose the TPU kernel's tiles, resident
32^3 windows, phases, unrolling and whole-window skips; the CUDA tracer
walks one ray a thread over the whole grid and has none of them, so they
are not swept.

    python -m wavefront_tpu_torch.tools.trace_tune [--frames 2] \
        [--compaction 0 1] [--skips 0 1] [--presort 0 1] \
        [--shade-bf16 0] [--device cuda]

Without a card it exits unless given `--device cpu`, which runs the
kernels' plain versions.
"""

from __future__ import annotations

import argparse
import itertools

import numpy as np
import torch

from wavefront_tpu_torch.headline import headline_setup
from wavefront_tpu_torch.render.renderer import Renderer
from wavefront_tpu_torch.tools import _sweep
from wavefront_tpu_torch.tools._timing import emit


def tune(scene, settings, basis, prefs, frames: int = 2, compaction=(0, 1),
         skips=(0, 1), presort=(0, 1), shade_bf16=(0,)) -> list:
    """One row a combination, then {"best": row} when a row has no
    truncated ray."""
    dev = torch.device(scene.device)
    out, best = [], None
    for comp, sk, ps, sb in itertools.product(compaction, skips, presort,
                                              shade_bf16):
        s = settings.replace(compaction=bool(comp), trace_skips=bool(sk),
                             trace_presort=bool(ps), shade_bf16=bool(sb))
        r = Renderer(s, device=dev)
        rec = {"compaction": comp, "skips": sk, "presort": ps,
               "shade_bf16": sb}
        img, aux = r.render(scene, basis, prefs, frame_count=0,
                            with_aux=True)
        if not np.all(np.isfinite(img)):
            out.append({**rec, "error": "nonfinite"})
            continue
        rec["frame_ms"] = _sweep.time_frames(r, scene, basis, prefs, frames)
        rec["device_busy_ms"] = _sweep.frame_profile(
            r, scene, basis, prefs)["device_busy_ms"]
        rec["truncated"] = int(aux["truncated"])
        out.append(rec)
        if rec["truncated"] == 0 and (best is None
                                      or rec["frame_ms"] < best["frame_ms"]):
            best = rec
    if best is not None:
        out.append({"best": best})
    return out


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--frames", type=int, default=2)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--compaction", type=int, nargs="+", default=[0, 1])
    p.add_argument("--skips", type=int, nargs="+", default=[0, 1])
    p.add_argument("--presort", type=int, nargs="+", default=[0, 1])
    p.add_argument("--shade-bf16", type=int, nargs="+", default=[0])
    p.add_argument("--device", default="cuda",
                   help="cuda, or cpu for the kernels' plain versions")
    args = p.parse_args(argv)
    dev = _sweep.device_of(args.device)
    scene, settings, basis, prefs = headline_setup(args.width, args.height,
                                                   4, device=dev)
    return emit(tune(scene, settings, basis, prefs, args.frames,
                     args.compaction, args.skips, args.presort,
                     args.shade_bf16), dev)


if __name__ == "__main__":
    main()

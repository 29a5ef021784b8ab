"""Frame stage-cost table at the headline frame.

Counterpart of `tools/stage_table.py`: each row renders the headline
(`headline.headline_setup`: 1920x1080, 4 bounces, NEE, compaction) with
one stage varied, so a stage's cost comes out as a delta of whole-frame
times; on the card each row also gives its device busy ms (torch.profiler
over 3 frames) and one frame's device ms by renderer stage (CUDA events
around the stage functions, `_sweep.stage_times`).

Rows:
  full       the headline as benched
  freetrace  a constant hit replaces the tracer
  notex      a constant texel replaces the fetch (general path)
  gtex       PyTorch's indexed atlas read in place of the texel kernel
             (the general path's option: the fused headline is unchanged)
  nonee_pdf  the NEE pdf sweep elided (general path)
  nee0       nee_type 0: no NEE sampling and no pdf sweep
  b1, b2     1 and 2 bounces: the marginal bounce
  nosort     trace_presort off and compaction off: no bounce sort at all
  dda        K1's unskipped march: trace_skips=False, the aux grid's
             empty-space distances cleared, so the tracer crosses every
             voxel boundary (the counterpart of the JAX tool's exhaustive
             XLA DDA); max_trace_steps=512 is set as the JAX row sets it,
             though the port's tracer budget is trace_events (auto:
             2048 steps, more than the grid's diameter), and the trace
             audit is off

The derived lines are the JAX tool's: `nee_cost_ms` (full - nee0),
`bounce_marginal_ms` (b2 - b1), `non_trace_floor_ms_upper` (freetrace),
`texel_gather_ms` (full - notex), `nee_pdf_sweep_ms` (full - nonee_pdf),
each from `frame_ms`, with `device_value` from device busy ms beside it.
Each row also gives its image's max |diff| from the `full` row's at one
frame count (the image-preserving rows: nosort, dda, gtex).

    python -m wavefront_tpu_torch.tools.stage_table [--frames 3] \
        [--rows full nosort dda] [--width 1920 --height 1080] \
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

ROWS = ("full", "freetrace", "notex", "gtex", "nonee_pdf", "nee0", "b1",
        "b2", "nosort", "dda")
# (name, minuend, subtrahend or None): the JAX tool's derived lines
DERIVED = (("nee_cost_ms", "full", "nee0"),
           ("bounce_marginal_ms", "b2", "b1"),
           ("non_trace_floor_ms_upper", "freetrace", None),
           ("texel_gather_ms", "full", "notex"),
           ("nee_pdf_sweep_ms", "full", "nonee_pdf"))


def variants(settings, prefs) -> dict:
    """Each row's (settings, prefs), the JAX tool's variants."""
    return {
        "full": (settings, prefs),
        "freetrace": (settings.replace(debug_stage="freetrace"), prefs),
        "notex": (settings.replace(debug_stage="notex"), prefs),
        "gtex": (settings.replace(shade_texel_kernel=False), prefs),
        "nonee_pdf": (settings.replace(debug_stage="nonee_pdf"), prefs),
        "nee0": (settings, prefs.replace(nee_type=0)),
        "b1": (settings.replace(num_bounces=1), prefs),
        "b2": (settings.replace(num_bounces=2), prefs),
        "nosort": (settings.replace(trace_presort=False, compaction=False),
                   prefs),
        "dda": (settings.replace(trace_skips=False, max_trace_steps=512,
                                 trace_audit=False), prefs),
    }


def table(scene, settings, basis, prefs, frames: int = 3, names=ROWS,
          images=None) -> list:
    """The rows named in `names`, then the derived lines whose rows ran.
    images: a dict that receives each row's image tensor (frame count
    1), when given."""
    dev = torch.device(scene.device)
    var = variants(settings, prefs)
    ref = Renderer(settings, device=dev).render(
        scene, basis, prefs, frame_count=1, as_numpy=False)
    out, ms, busy = [], {}, {}
    for name in names:
        s, pr = var[name]
        r = Renderer(s, device=dev)
        ms[name] = _sweep.time_frames(r, scene, basis, pr, frames)
        img = r.render(scene, basis, pr, frame_count=1, as_numpy=False)
        if images is not None:
            images[name] = img
        busy[name] = _sweep.frame_profile(r, scene, basis, pr)[
            "device_busy_ms"]
        stages = _sweep.stage_times(scene, s, basis, pr, 1)
        out.append({"row": name, "frame_ms": ms[name],
                    "device_busy_ms": busy[name],
                    "max_abs_diff": float((img - ref).abs().max()),
                    "stage_ms": stages["ms_by_stage"],
                    "stage_other_ms": stages["other_ms"],
                    "stage_frame_ms": stages["frame_ms"]})
    for key, a, b in DERIVED:
        if a not in ms or (b is not None and b not in ms):
            continue

        def diff(v):
            if v[a] is None:
                return None
            return v[a] - (0.0 if b is None else v[b])

        out.append({"derived": key, "value": diff(ms),
                    "device_value": diff(busy)})
    return out


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--frames", type=int, default=3)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--rows", nargs="+", default=list(ROWS), choices=ROWS)
    p.add_argument("--device", default="cuda",
                   help="cuda, or cpu for the kernels' plain versions")
    args = p.parse_args(argv)
    dev = _sweep.device_of(args.device)
    scene, settings, basis, prefs = headline_setup(args.width, args.height,
                                                   4, device=dev)
    return emit(table(scene, settings, basis, prefs, args.frames, args.rows),
                dev)


if __name__ == "__main__":
    main()

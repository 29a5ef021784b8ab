"""The golden frame and the headline program on the card, held to their
references.

Counterpart of `tools/tpu_parity.py`.  The default check renders the
config-1 golden scene (`headline.config1_grid` / `config1_pose`, the
settings of `tests/golden/config1_256.npz`'s `meta`) through the normal
`Renderer` on the card and holds it to the stored golden with the JAX
tool's relative gate (`compare`): a pixel agrees when its max-channel
|diff| is under 1e-3 * max(1, |want|); the gate passes with fewer than
0.5% of the pixels divergent and a relative RMSE under 1e-3 over the
agreeing ones.

`--bench` gates the headline program itself (`headline.headline_setup`,
the trace audit on): no ray may exhaust the tracer's budget
(`truncated` 0) and none may overflow the sparse-NEE slots
(`nee_overflow` 0), and its image must pass the gate above against the
same frame traced by the exhaustive plain march: `intersect.trace_plain`
with a 512-step budget, handed to `render_frame` as its tracer (the
port's counterpart of the JAX reference's `use_column_trace=False` DDA;
512 steps cross any chord of the 160x32x160 grid).  Same rays, draws and
shading: only the traversal differs.

    python -m wavefront_tpu_torch.tools.gpu_parity [--device cuda]
    python -m wavefront_tpu_torch.tools.gpu_parity --bench \
        [--width 1920 --height 1080 --bounces 4]

One JSON line, with the card's name and power limit; exits 1 when the
gate fails.  Without a card it exits unless given `--device cpu`, which
runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from wavefront_tpu_torch.core.config import RenderingPreferences, RenderSettings
from wavefront_tpu_torch.headline import (
    ASSETS,
    REPO,
    config1_grid,
    config1_pose,
    headline_setup,
)
from wavefront_tpu_torch.render.intersect import trace_plain
from wavefront_tpu_torch.render.renderer import Renderer, render_frame
from wavefront_tpu_torch.render.scene import VoxelScene
from wavefront_tpu_torch.tools import _sweep
from wavefront_tpu_torch.tools._timing import emit
from wavefront_tpu_torch.world.blocks import BlockRegistry

GOLDEN = os.path.join(REPO, "tests", "golden", "config1_256.npz")
# the exhaustive reference march's step budget
REFERENCE_STEPS = 512


def compare(got, want, frac_limit: float = 0.005) -> dict:
    """The JAX tool's `_compare`: agreement relative for bright pixels
    (the radiance image is HDR: emissive faces reach ~660, where 1e-3
    absolute would ask ~2e-6 relative), absolute on [0, 1]-scale ones."""
    got, want = np.asarray(got), np.asarray(want)
    diff = np.abs(got - want).max(axis=-1)
    tol = 1e-3 * np.maximum(1.0, np.abs(want).max(axis=-1))
    agree = diff < tol
    frac_divergent = float(1.0 - agree.mean())
    rel = diff / np.maximum(1.0, np.abs(want).max(axis=-1))
    rmse = float(np.sqrt(np.mean(rel[agree] ** 2)))
    return {
        "rmse_rel_agreeing": rmse,
        "frac_divergent_pixels": frac_divergent,
        "divergent_count": int((~agree).sum()),
        "max_rel": float(rel.max()),
        "pass": bool(frac_divergent < frac_limit and rmse < 1e-3),
    }


def golden_scene(device, width=None, height=None):
    """(scene, settings, basis, prefs, golden image, frame) of the stored
    golden: its scene and pose, the settings and frame of its `meta`; at
    another `width` x `height` the same scene at that size (the golden
    image is then still the stored one)."""
    blob = np.load(GOLDEN)
    w, h, bounces, nee_type, frame = (int(x) for x in blob["meta"])
    registry = BlockRegistry.load(ASSETS)
    scene = VoxelScene(registry, config1_grid(registry), (0, 0, 0),
                       max_light_prims=256, device=device)
    settings = RenderSettings(width=width or w, height=height or h,
                              num_bounces=bounces, max_trace_steps=96)
    return (scene, settings, config1_pose(),
            RenderingPreferences(nee_type=nee_type), blob["image"], frame)


def golden_check(device) -> dict:
    """The golden frame on `device` against the stored golden."""
    scene, settings, basis, prefs, gold, frame = golden_scene(device)
    got = Renderer(settings, device=device).render(scene, basis, prefs,
                                                   frame_count=frame)
    return {"check": "golden", **compare(got, gold),
            "config": f"config 1 ({settings.width}x{settings.height}x"
                      f"{settings.num_bounces}, nee={prefs.nee_type})"}


def reference_frame(scene, settings, basis, prefs, frame: int = 0):
    """The frame of `settings` traced by the exhaustive plain march
    (`trace_plain`, REFERENCE_STEPS steps), on the scene's device: the
    image tensor."""
    ref = settings.replace(trace_events=REFERENCE_STEPS, trace_audit=False,
                           trace_presort=False)
    img, _ = render_frame(
        scene.get_arrays(), basis.eye, basis.front, basis.right, basis.up,
        frame, settings=ref, nee_type=prefs.nee_type,
        sort_type=prefs.sort_type, trace=trace_plain)
    return img


def bench_gate(scene, settings, basis, prefs) -> dict:
    """The headline program on the scene's device, audited, against the
    reference frame: the JAX tool's `bench_gate` row."""
    if not settings.trace_audit:
        raise ValueError("bench_gate: the headline program must carry the "
                         "trace audit")
    dev = torch.device(scene.device)
    img, aux = Renderer(settings, device=dev).render(
        scene, basis, prefs, frame_count=0, with_aux=True)
    want = reference_frame(scene, settings, basis, prefs, 0)
    rec = {"check": "bench", **compare(img, want.cpu().numpy()),
           "config": f"bench headline ({settings.width}x{settings.height}x"
                     f"{settings.num_bounces}, the tracer vs the "
                     f"{REFERENCE_STEPS}-step plain march)",
           "truncated_rays": aux["truncated"],
           "nee_overflow_rays": aux["nee_overflow"]}
    rec["pass"] = bool(rec["pass"] and aux["truncated"] == 0
                       and aux["nee_overflow"] == 0)
    return rec


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--bench", action="store_true",
                   help="gate the headline program instead of the golden")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--bounces", type=int, default=4)
    p.add_argument("--device", default="cuda",
                   help="cuda, or cpu for the kernels' plain versions")
    args = p.parse_args(argv)
    dev = _sweep.device_of(args.device)
    if args.bench:
        rec = bench_gate(*headline_setup(args.width, args.height,
                                         args.bounces, device=dev))
    else:
        rec = golden_check(dev)
    rows = emit([rec], dev)
    if not rec["pass"]:
        raise SystemExit(1)
    return rows


if __name__ == "__main__":
    main()

"""The headline benchmark: Mrays/s of the headline frame on the card.

Counterpart of the repository's `bench.py` (its timed measure,
`run_inner`).  It builds the headline (`headline.headline_setup`:
1920x1080, 4 bounces, NEE, compaction, the trace audit on), renders one
audited frame (its `truncated` and `nee_overflow` go to stderr; the
`gpu_parity --bench` gate holds both to 0), warms up one
`render_batch(k)` outside the timed window, then times `--frames` frames
in batches of k: each batch's images are summed into an accumulator on
the device, and one scalar of it is read back after a synchronize, so
the clock stops when every frame has finished.

One JSON line: {"metric": "Mrays_per_sec", "value", "unit": "Mray/s",
"vs_baseline", "frame_ms", "card", "power_limit", "device"};
`vs_baseline` is the value over the north star of 1000 Mray/s
(BASELINE.json).  Nothing is retried and no earlier number stands in
for a failed run: a failure raises.

    python -m wavefront_tpu_torch.bench [--width 1920 --height 1080] \
        [--bounces 4] [--batch 5] [--frames 10] [--device cuda]

Without a card it exits unless given `--device cpu`, which times the
kernels' plain versions on the host clock.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from wavefront_tpu_torch.headline import headline_setup
from wavefront_tpu_torch.render.renderer import Renderer
from wavefront_tpu_torch.tools import _sweep
from wavefront_tpu_torch.tools._timing import card, sync

# the north star: 1 Gray/s on one chip (BASELINE.json)
BASELINE_MRAYS = 1000.0


def measure(scene, settings, basis, prefs, frames: int = 10,
            k: int = 5) -> tuple:
    """(the benchmark's row, the audit frame's aux) on the scene's
    device; the row lacks the card's fields."""
    dev = torch.device(scene.device)
    renderer = Renderer(settings, device=dev)
    img, aux = renderer.render(scene, basis, prefs, frame_count=0,
                               with_aux=True)
    if not np.all(np.isfinite(img)):
        raise FloatingPointError("benchmark produced NaNs")
    print(f"trace-audit: {aux['truncated']} rays exhausted the step "
          f"budget, {aux['nee_overflow']} rays overflowed the sparse-NEE "
          "slots (gate: gpu_parity --bench asserts 0)", file=sys.stderr)
    warm = renderer.render_batch(scene, basis, prefs, frame_count=0, k=k,
                                 as_numpy=False)
    if not np.isfinite(float(warm.sum())):
        raise FloatingPointError("benchmark produced NaNs")
    sync(dev)
    t0 = time.perf_counter()
    acc = None
    for f0 in range(1, frames + 1, k):
        out = renderer.render_batch(scene, basis, prefs, frame_count=f0,
                                    k=min(k, frames + 1 - f0),
                                    as_numpy=False)
        part = out.sum(dim=0)
        acc = part if acc is None else acc + part
    sync(dev)
    total = float(acc.sum())
    dt = (time.perf_counter() - t0) / frames
    if not np.isfinite(total):
        raise FloatingPointError("benchmark produced NaNs")
    mrays = settings.width * settings.height * settings.num_bounces / dt / 1e6
    return {"metric": "Mrays_per_sec", "value": mrays, "unit": "Mray/s",
            "vs_baseline": mrays / BASELINE_MRAYS,
            "frame_ms": dt * 1e3}, aux


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--bounces", type=int, default=4)
    p.add_argument("--batch", type=int, default=5,
                   help="frames a render_batch call (k)")
    p.add_argument("--frames", type=int, default=10)
    p.add_argument("--device", default="cuda",
                   help="cuda, or cpu for the kernels' plain versions")
    args = p.parse_args(argv)
    dev = _sweep.device_of(args.device)
    rec, _ = measure(*headline_setup(args.width, args.height, args.bounces,
                                     device=dev),
                     frames=args.frames, k=args.batch)
    name, limit = card() if dev.type == "cuda" else (None, None)
    rec.update(card=name, power_limit=limit, device=str(dev))
    print(json.dumps(rec), flush=True)
    return [rec]


if __name__ == "__main__":
    main()

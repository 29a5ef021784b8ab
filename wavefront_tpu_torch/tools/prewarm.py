"""Build the kernels and run once each program the benchmark and the
parity gate run, timing each first call.

Counterpart of `tools/prewarm.py`, which fills the JAX package's
persistent compile cache.  The port compiles per source, not per shape:
`_build.build_all()` builds every missing kernel library (one `nvcc` a
source, all at once) into `build/wavefront_tpu_torch/`, where later
processes load it.  Then each program the JAX tool warms runs once: the
headline (`bench` and `gpu_parity --bench`), the `--bench` reference
(the exhaustive 512-step plain march, `gpu_parity.reference_frame`) and
the timed loop's batch (`render_batch(k=5)`).

    python -m wavefront_tpu_torch.tools.prewarm [--width 1920 \
        --height 1080] [--bounces 4] [--batch 5] [--device cuda]

One JSON line a row: the build's seconds, then each program's first-call
seconds and whether its image is finite, with the card's name and power
limit.  Without a card it exits unless given `--device cpu`, which builds
nothing and runs the plain versions.
"""

from __future__ import annotations

import argparse
import time

import torch

from wavefront_tpu_torch.headline import headline_setup
from wavefront_tpu_torch.kernels import _build
from wavefront_tpu_torch.render.renderer import Renderer
from wavefront_tpu_torch.tools import _sweep
from wavefront_tpu_torch.tools._timing import emit, sync
from wavefront_tpu_torch.tools.gpu_parity import reference_frame


def _first_call(name: str, fn, dev) -> dict:
    t0 = time.perf_counter()
    img = fn()
    finite = bool(torch.isfinite(img).all())
    sync(dev)
    return {"row": name, "seconds": time.perf_counter() - t0,
            "finite": finite}


def warm(scene, settings, basis, prefs, k: int = 5) -> list:
    """The programs' rows on the scene's device (the build first on a
    card)."""
    dev = torch.device(scene.device)
    rows = []
    if dev.type == "cuda":
        t0 = time.perf_counter()
        _build.build_all()
        rows.append({"row": "build", "seconds": time.perf_counter() - t0,
                     "sources": len(_build.SOURCES)})
    renderer = Renderer(settings, device=dev)
    rows.append(_first_call("headline", lambda: renderer.render(
        scene, basis, prefs, frame_count=0, as_numpy=False), dev))
    rows.append(_first_call("bench_reference", lambda: reference_frame(
        scene, settings, basis, prefs), dev))
    rows.append(_first_call(f"headline_batch_k{k}", lambda: Renderer(
        settings, device=dev).render_batch(scene, basis, prefs,
                                           frame_count=1, k=k,
                                           as_numpy=False), dev))
    return rows


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--bounces", type=int, default=4)
    p.add_argument("--batch", type=int, default=5)
    p.add_argument("--device", default="cuda",
                   help="cuda, or cpu for the kernels' plain versions")
    args = p.parse_args(argv)
    dev = _sweep.device_of(args.device)
    rows = warm(*headline_setup(args.width, args.height, args.bounces,
                                device=dev), k=args.batch)
    return emit(rows, dev)


if __name__ == "__main__":
    main()

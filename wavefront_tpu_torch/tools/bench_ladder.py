"""The benchmark ladder (BASELINE.md configs 1-5 + streamed-window rows).

Counterpart of `tools/bench_ladder.py`: the same configs, built from the
port's own modules, and one JSON line per config with the JAX tool's
keys: `frame_ms` and `mrays_per_sec` over the timed frames, `compile_s`,
the trace audit (`truncated_rays`, `nee_overflow_rays`) where the
config's settings turn it on, the `recenter_*` row of configs 6 and 8
and the `batched_*` row of configs 1 and 5.

Configs:
  1  256^2 x1, single 16^3 chunk (also reports the k=8 BATCHED effective
     frame time: config 1 is bound by launches and host syncs)
  2  512^2 x2, one 32^3 chunk
  3  the headline program (headline.headline_setup: 1080p x4, NEE)
  4  config 3 + one block edit per frame (incremental scene updates)
  5  1440p x8 + accumulation (the primary-hit cache, a TemporalAccumulator
     in the frame loop, and a k=8 accumulating batch)
  6  config 3's workload on the game layer's streamed window: load_radius
     6 -> 13x3x13 chunks = 416x96x416 voxels
  7  config 6 + one block edit per frame through the chunk manager
  8  the reference's default workload: 1024x1024 x6 on the streamed window

Timing follows the JAX tool's loop: a settle frame, then `--frames`
frames timed on the host clock and ended by `torch.cuda.synchronize()`
(configs 4 and 7 edit and synchronize every frame).  `compile_s` is the
first frame's seconds (with the primary cache, the first two frames', as
the JAX tool warms its cached variant), including the load of the CUDA
kernels, or their build when the build directory lacks them; nothing is
compiled per shape here.  Numbers are printed unrounded.

    python -m wavefront_tpu_torch.tools.bench_ladder [--configs 1 2 3] \
        [--frames 5] [--batch 8] [--device cuda]

Without a card it raises unless given `--device cpu`, which runs the
kernels' plain versions.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from wavefront_tpu_torch.core.camera import SphericalCamera
from wavefront_tpu_torch.core.config import (
    RenderingPreferences,
    RenderSettings,
    WorldSettings,
)
from wavefront_tpu_torch.headline import ASSETS, headline_setup, streamed_setup
from wavefront_tpu_torch.render.accumulate import TemporalAccumulator
from wavefront_tpu_torch.render.renderer import Renderer
from wavefront_tpu_torch.render.scene import VoxelScene
from wavefront_tpu_torch.world.blocks import BlockRegistry
from wavefront_tpu_torch.world.worldgen import WorldGenerator

# the block the edit configs place and break: solid, so an edit is the
# gameplay case (the JAX tool's block 5)
EDIT_BLOCK = "stone"


def default_pose():
    """The camera basis of configs 1 and 2."""
    cam = SphericalCamera()
    cam.set_root_position([0.0, 12.0, 0.0])
    cam.offset = 28.0
    cam.yaw = 0.6
    cam.pitch = -0.35
    return cam.eye_front_right_up()


def build(config: int, registry: BlockRegistry, device="cuda"):
    """(scene, chunk manager or None, settings, nee_type, camera basis or
    None for the default pose) of one config.  Configs 3/4 are the
    headline program; config 5 reuses its scene and pose at 1440p x8 with
    the primary cache; configs 6-8 run the game layer's streamed window."""
    if config == 1:
        gen = WorldGenerator(WorldSettings(chunk_size=16), registry)
        grid, origin = gen.generate_chunk((0, 0, 0)), (0, 0, 0)
        settings = RenderSettings(width=256, height=256, num_bounces=1,
                                  max_trace_steps=64)
        nee = 0
    elif config == 2:
        gen = WorldGenerator(WorldSettings(), registry)
        grid, origin = gen.generate_chunk((0, 0, 0)), (0, 0, 0)
        settings = RenderSettings(width=512, height=512, num_bounces=2,
                                  max_trace_steps=96)
        nee = 0
    elif config in (3, 4):
        scene, settings, basis, _ = headline_setup(device=device)
        return scene, None, settings, 1, basis
    elif config == 5:
        scene, settings, basis, _ = headline_setup(
            2560, 1440, 8, device=device, cache_primary=True)
        return scene, None, settings, 1, basis
    elif config in (6, 7):
        scene, cm, settings, basis, _ = streamed_setup(1920, 1080, 4,
                                                       device=device)
        return scene, cm, settings, 1, basis
    elif config == 8:
        scene, cm, settings, basis, _ = streamed_setup(1024, 1024, 6,
                                                       device=device)
        return scene, cm, settings, 1, basis
    else:
        raise SystemExit(f"unknown config {config}")
    scene = VoxelScene(registry, grid, origin, max_light_prims=1024,
                       device=device)
    return scene, None, settings, nee, None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def frame_step(config: int, scene, cm, renderer: Renderer, basis, prefs,
               accum=None):
    """One frame of `config`'s timed loop as a function of its frame
    count f: config 4's edit of the scene, or config 7's through the
    chunk manager (stone and air in turn at (8 + f % 16, y, 3)), the
    render, and the accumulator's fold (config 5).  Returns the image
    tensor; the edit configs synchronize, as an interactive loop that
    reads its image does."""
    reg = scene.registry
    stone, air = reg.block_idx(EDIT_BLOCK), reg.air

    def step(f: int):
        if config == 4:
            # the headline grid spans y 0..31
            scene.set_block((8 + f % 16, 20, 3), stone if f % 2 else air)
        elif config == 7 and cm is not None:
            cm.set_block((8 + f % 16, 30, 3), stone if f % 2 else air)
        out = renderer.render(scene, basis, prefs, frame_count=f,
                              as_numpy=False)
        if accum is not None:
            out = accum.add(out, key="static")
        if config in (4, 7):
            _sync(out.device)
        return out

    return step


def row(config: int, scene, settings: RenderSettings, basis, prefs, *,
        cm=None, frames: int = 5, batch: int = 8) -> dict:
    """The ladder's row of one config (the JAX tool's keys), measured on
    the scene's device.  Renders through a new `Renderer`; edits the
    scene (configs 4, 7) and recenters the chunk manager's window
    (configs 6, 8) as the JAX tool does."""
    dev = torch.device(scene.device)
    renderer = Renderer(settings, device=dev)
    accum = TemporalAccumulator() if config == 5 else None

    t0 = time.perf_counter()
    img = renderer.render(scene, basis, prefs, frame_count=0)
    if settings.cache_primary:
        # the first cached frame, as the JAX tool warms its second variant
        renderer.render(scene, basis, prefs, frame_count=0)
    compile_s = time.perf_counter() - t0
    if not np.all(np.isfinite(img)):
        raise FloatingPointError(f"ladder config {config}: the first frame "
                                 "is not finite")

    # settle frame
    renderer.render(scene, basis, prefs, frame_count=0, as_numpy=False)
    _sync(dev)
    step = frame_step(config, scene, cm, renderer, basis, prefs, accum)
    t0 = time.perf_counter()
    for f in range(1, frames + 1):
        step(f)
    _sync(dev)
    dt = (time.perf_counter() - t0) / frames

    rays = settings.n_rays * settings.num_bounces
    rec = {"config": config, "frame_ms": dt * 1000,
           "mrays_per_sec": rays / dt / 1e6, "compile_s": compile_s}
    if settings.trace_audit:
        _, aux = renderer.render(scene, basis, prefs, frame_count=1,
                                 as_numpy=False, with_aux=True)
        rec["truncated_rays"] = int(aux["truncated"])
        rec["nee_overflow_rays"] = int(aux["nee_overflow"])

    if config in (6, 8) and cm is not None:
        rec.update(recenter(cm, scene, renderer, basis, prefs))

    if config in (1, 5) and batch > 1:
        # k frames a call
        kw = dict(k=batch, accumulate=config == 5, as_numpy=False)
        renderer.render_batch(scene, basis, prefs, 0, **kw)
        _sync(dev)
        t0 = time.perf_counter()
        renderer.render_batch(scene, basis, prefs, batch, **kw)
        _sync(dev)
        bdt = (time.perf_counter() - t0) / batch
        rec["batched_frame_ms"] = bdt * 1000
        rec["batched_mrays_per_sec"] = rays / bdt / 1e6
        rec["batch_k"] = batch
    return rec


def recenter(cm, scene, renderer: Renderer, basis, prefs) -> dict:
    """The recenter row: the centre moves one chunk along +x, its chunks
    are generated synchronously, the window's rebuild runs in the
    background while frames are served on the old window (the stale
    frames), then the adoption (`_adopt_rebuild`: the device writes and
    the light set) and the first frame on the new window."""
    dev = torch.device(scene.device)
    cx0, cy0, cz0 = cm.center_chunk
    cm.center_chunk = (cx0 + 1, cy0, cz0)
    for key in cm._window_keys(cm.center_chunk):
        cm._request_chunk(key)
    cm._window_dirty = True
    cm._async_rebuild_opt = True
    t_rec0 = time.perf_counter()
    cm._submit_rebuild()
    stale_ms = []
    while cm._rebuild_job is not None and not cm._rebuild_job.done():
        tf = time.perf_counter()
        renderer.render(scene, basis, prefs, frame_count=90 + len(stale_ms),
                        as_numpy=False)
        _sync(dev)
        stale_ms.append((time.perf_counter() - tf) * 1000)
    t_adopt0 = time.perf_counter()
    cm._adopt_rebuild()
    renderer.render(scene, basis, prefs, frame_count=89, as_numpy=False)
    _sync(dev)
    now = time.perf_counter()
    rec = {"recenter_total_s": now - t_rec0,
           "recenter_adopt_frame_ms": (now - t_adopt0) * 1000,
           "recenter_stale_frames": len(stale_ms)}
    if stale_ms:
        rec["recenter_stale_frame_ms"] = float(np.mean(stale_ms))
    return rec


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--configs", type=int, nargs="+", default=[1, 2, 3, 4, 5])
    p.add_argument("--frames", type=int, default=5)
    p.add_argument("--batch", type=int, default=8,
                   help="batch size for the config 1/5 batched rows")
    p.add_argument("--device", default="cuda",
                   help="torch device of the scenes and the renderer; cpu "
                        "runs the kernels' plain versions")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError(
            "bench_ladder: CUDA is not available; pass --device cpu to run "
            "on the CPU with the plain PyTorch kernels")

    registry = BlockRegistry.load(ASSETS)
    for config in args.configs:
        scene, cm, settings, nee, basis = build(config, registry, args.device)
        rec = row(config, scene, settings,
                  default_pose() if basis is None else basis,
                  RenderingPreferences(nee_type=nee), cm=cm,
                  frames=args.frames, batch=args.batch)
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()

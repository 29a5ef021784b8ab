"""Application driver (reference src/main.rs).

The reference opens a 1024x1024 winit window, builds the scene with an ego
cube entity under kinematic physics (main.rs:97-114), and renders on every
RedrawRequested with a once-per-second fps log (main.rs:871-883).  This
driver reproduces the same bootstrap headlessly (no display stack on the
host): a fly-through loop that steps the world, renders, logs fps, and can
save auto-numbered screenshots.

The counterpart of `wavefront_tpu.app.main`, with its flags, defaults and
printed lines, plus `--device` (default cuda): the world's scene and the
renderer live there.  Without a card it raises unless `--device cpu`
asks for the CPU (the kernels' plain versions).  The TPU schedule
settings `build_world` sets are accepted by the port and change nothing.

Run:  python -m wavefront_tpu_torch.app.main --frames 60 --screenshot-every 30
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from wavefront_tpu_torch.core.camera import SphericalCamera
from wavefront_tpu_torch.core.config import (
    RenderingPreferences,
    RenderSettings,
    WorldSettings,
)
from wavefront_tpu_torch.world import meshes
from wavefront_tpu_torch.world.blocks import BlockRegistry
from wavefront_tpu_torch.world.game_world import (
    EntityCreationData,
    EntityPhysicsData,
    GameWorld,
    Mesh,
    translation,
)
from wavefront_tpu_torch.world.input import Event


def build_world(args) -> GameWorld:
    """Scene bootstrap (reference build_scene, main.rs:40-170)."""
    assets = args.assets or os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "assets",
    )
    registry = BlockRegistry.load(assets)
    camera = SphericalCamera()
    camera.set_rendering_preferences(
        RenderingPreferences(nee_type=args.nee_type, sort_type=args.sort_type)
    )
    world = GameWorld(
        registry,
        settings=RenderSettings(
            width=args.width,
            height=args.height,
            num_bounces=args.bounces,
            max_trace_steps=args.max_steps,
            # accumulation implies a mostly-static camera: reuse bounce-0
            # intersections between frames
            cache_primary=getattr(args, "accumulate", False),
            # the tuned production trace config for the STREAMED window
            # (ladder configs 6-8; the app plays the same world class):
            # terminal-ray compaction + hoisted presort, unrolled event
            # groups, lean/full skip alternation, tile 1024 (streamed
            # straggler granularity, -18% vs 2048 on the hemisphere fan)
            # and the diffuse-bounce phase schedule.  Image-invariant
            # (test_golden/test_batch pin parity); the interactive loop
            # runs the same program shape the benchmarks time.
            compaction=True,
            trace_unroll=4,
            trace_tile=1024,
            trace_skip_stride=2,
            trace_phases=2,
            trace_phase_events=16,
            trace_phases_at=(1, 2, 3, 4),
            # a caller that reads each step's audit (GameWorld.last_aux)
            # asks for it; the app's flags do not
            trace_audit=getattr(args, "trace_audit", False),
        ),
        world_settings=WorldSettings(),
        camera=camera,
        window_chunks=args.window_chunks,
        headless=args.headless,
        device=args.device,
    )

    # ego cube entity with kinematic physics (main.rs:99-114)
    verts, uv, tex = meshes.unitcube()
    lo, hi = meshes.mesh_aabb(verts)
    world.add_entity(
        0,
        EntityCreationData(
            mesh=Mesh(verts, uv, tex),
            isometry=translation(0.0, 5.0, 0.0),
            physics=EntityPhysicsData(
                rigid_body_type="kinematic",
                half_extents=(hi - lo) / 2,
                linvel=np.zeros(3),
                angvel=np.zeros(3),
                controlled=True,
            ),
        ),
    )

    # optional physics demo: a column of dynamic cubes that fall, collide
    # with each other, and stack on the terrain (entity-entity contacts)
    for i in range(args.drop_cubes):
        world.add_entity(
            1 + i,
            EntityCreationData(
                mesh=Mesh(verts, uv, tex),
                isometry=translation(2.0, 8.0 + 2.0 * i, 2.0),
                physics=EntityPhysicsData(
                    rigid_body_type="dynamic",
                    half_extents=(hi - lo) / 2,
                    linvel=np.zeros(3),
                    angvel=np.zeros(3),
                    controlled=False,
                ),
            ),
        )
    return world


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--width", type=int, default=1024)   # main.rs:801
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--bounces", type=int, default=6)    # interactive_rendering.rs:653
    p.add_argument("--max-steps", type=int, default=192)
    p.add_argument("--frames", type=int, default=120)
    p.add_argument("--nee-type", type=int, default=1)
    p.add_argument("--sort-type", type=int, default=0)
    p.add_argument("--window-chunks", type=int, default=2)
    p.add_argument("--screenshot-every", type=int, default=0)
    p.add_argument("--fly-speed", type=float, default=4.0)
    p.add_argument("--drop-cubes", type=int, default=0,
                   help="spawn N dynamic cubes that fall and stack "
                        "(entity-entity collision demo)")
    p.add_argument("--serve", type=int, default=0, metavar="PORT",
                   help="stream rendered frames to a browser at "
                        "http://localhost:PORT/ (live viewer)")
    p.add_argument("--interactive", action="store_true",
                   help="drive the world from the browser's keyboard/mouse "
                        "(viewer POST /input) instead of the scripted "
                        "fly-through; implies --serve 8787 unless --serve "
                        "is given")
    p.add_argument("--assets", default=None)
    p.add_argument("--headless", action="store_true",
                   help="world-only run: skip the renderer entirely "
                        "(rendering is always off-screen; without this "
                        "flag every frame renders and can screenshot)")
    p.add_argument("--accumulate", action="store_true",
                   help="temporal accumulation while the camera holds still "
                        "(BASELINE config 5)")
    p.add_argument("--hold", action="store_true",
                   help="hold the camera still instead of flying")
    p.add_argument("--device", default="cuda",
                   help="torch device of the scene and the renderer; "
                        "cpu runs the kernels' plain versions")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise RuntimeError(
            "app: CUDA is not available; pass --device cpu to run on the "
            "CPU with the plain PyTorch kernels")

    world = build_world(args)
    accum = None
    if args.accumulate:
        from wavefront_tpu_torch.render.accumulate import TemporalAccumulator

        accum = TemporalAccumulator()

    viewer = None
    if args.interactive and not args.serve:
        args.serve = 8787
    if args.serve:
        from wavefront_tpu_torch.app.viewer import Viewer

        viewer = Viewer(port=args.serve)
        print(f"live viewer: http://localhost:{viewer.port}/")

    # fps counter (reference main.rs:871-883)
    frames_in_second = 0
    second_start = time.perf_counter()

    for frame in range(args.frames):
        if args.interactive:
            # live loop: the browser's events (viewer POST /input) drive
            # camera orbit, WASD, and click place/break — the reference's
            # interactive contract (main.rs:871-883)
            for e in viewer.drain_events():
                world.handle_window_event(e)
        elif not args.hold:
            # scripted fly-through: hold W and slowly orbit
            world.handle_window_event(Event("key_down", key="w"))
            world.camera.yaw += 0.01

        t0 = time.perf_counter()
        world.step()
        if accum is not None and world.last_image is not None:
            pose = (tuple(world.camera.root_pos), world.camera.yaw,
                    world.camera.pitch, world.camera.offset)
            world.last_image = np.asarray(
                accum.add(world.last_image, key=pose)
            )
        dt = time.perf_counter() - t0
        if viewer is not None and world.last_image is not None:
            viewer.publish(world.last_image)

        frames_in_second += 1
        now = time.perf_counter()
        if now - second_start >= 1.0:
            print(f"fps: {frames_in_second}  (last frame {dt*1000:.1f} ms)")
            frames_in_second = 0
            second_start = now

        if args.screenshot_every and frame % args.screenshot_every == 0:
            prefs = world.camera.rendering_preferences()
            world.camera.set_rendering_preferences(
                RenderingPreferences(
                    nee_type=prefs.nee_type,
                    sort_type=prefs.sort_type,
                    debug_view=prefs.debug_view,
                    should_screenshot=True,
                )
            )

    print(f"done: {args.frames} frames")


if __name__ == "__main__":
    main()

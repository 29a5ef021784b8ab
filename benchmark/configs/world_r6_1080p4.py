"""world_r6_1080p4: the game's world stepped as a player holding still,
and its reference.

`build` makes the system under test with the program's own entry point,
`app/main.py::build_world` (the app's settings, its `GameWorld` on the
reference-scale window with the ego cube, a kinematic physics entity),
at the configuration's frame, with the trace audit on.  Set-up steps the
world until its chunk manager has generated and adopted the whole
window.  Each image is one `GameWorld.step`: the manager pipeline
[chunk, physics, ego, scene], the entity table, and the render, whose
image and audit the step keeps (`last_image`, `last_aux`).  The view
turns the camera's own yaw about its root; the root and its rotation
stay what the ego manager sets each step.  `reference` works out the
same window again from the assets and the sizes alone, with the ego
cube's 12 triangles at the ego's place.
"""

from __future__ import annotations

import argparse
import time

from benchmark.reference import lights, world
from benchmark.reference.render import Reference


class GameStep:
    def __init__(self, cfg: dict, overrides: dict, device: str, phases: dict):
        from wavefront_tpu_torch.app.main import build_world
        from wavefront_tpu_torch.kernels import _build

        t = time.perf_counter()
        args = argparse.Namespace(
            width=cfg["width"], height=cfg["height"],
            bounces=cfg["num_bounces"], max_steps=cfg["max_trace_steps"],
            nee_type=cfg["nee_type"], sort_type=0, window_chunks=None,
            assets=None, headless=False, device=device, accumulate=False,
            drop_cubes=0, trace_audit=cfg["trace_audit"])
        self.world = build_world(args)
        if not hasattr(self.world, "last_aux"):
            raise RuntimeError("world_r6_1080p4: the program's GameWorld "
                               "keeps no audit of its step (last_aux)")
        if overrides:
            settings = self.world.settings.replace(**overrides)
            self.world.settings = self.world.renderer.settings = settings
        phases["world"] = time.perf_counter() - t
        t = time.perf_counter()
        if device != "cpu":
            _build.build_all()
        phases["kernels"] = time.perf_counter() - t
        t = time.perf_counter()
        # the first step asks for the window's chunks; once they have
        # landed, the next submits the window's rebuild, which is adopted
        self.world.step()
        cm = self.world.managers[0]
        for f in list(cm._pending.values()):
            f.result()
        self.world.step()
        cm.flush_rebuild()
        phases["window"] = time.perf_counter() - t

    def frame(self, yaw: float, frame_count: int, k: int = 1):
        """One `GameWorld.step` at the view's yaw and frame count: its
        image on the host and its audit."""
        if k != 1:
            raise ValueError("world_r6_1080p4: one frame an image")
        self.world.camera.yaw = yaw
        self.world.frame_count = frame_count
        self.world.step()
        return self.world.last_image, self.world.last_aux


# the system under test, made from the sizes, the traffic's settings
# overrides, the device, and a dict that receives set-up phases' seconds
build = GameStep


def reference(cfg: dict, assets: str, device):
    """(Reference scene, basis of a yaw) from the assets and the sizes:
    the window's terrain, its light set and the ego cube's triangles."""
    blocks = world.load_blocks(assets)
    grid = world.terrain(blocks, cfg["grid_origin"], cfg["grid"], device,
                         seed=cfg["worldgen_seed"]).cpu().numpy()
    ego = cfg["ego"]
    verts, uv, tex = world.cube_mesh(dims=ego["dims"],
                                     tex_offset=ego["tex_offset"])
    verts = world.place(verts, [[1.0, 0.0, 0.0, ego["translation"][0]],
                                [0.0, 1.0, 0.0, ego["translation"][1]],
                                [0.0, 0.0, 1.0, ego["translation"][2]]])
    ref = Reference(grid, cfg["grid_origin"], blocks,
                    lights.light_set(grid, cfg["grid_origin"], blocks,
                                     tris=lights.emissive_tris(verts, tex,
                                                               blocks)),
                    tris=(verts, uv, tex), device=device)
    cam = cfg["camera"]

    def basis(yaw: float):
        return world.orbit_basis(ego["translation"], cam["offset"], yaw,
                                 cam["pitch"])

    return ref, basis

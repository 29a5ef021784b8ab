"""lamps_r6_1080p4: the streamed window lit by player-placed lamps, and
its reference.

`build` makes the system under test with the program's own entry point,
`headline.lamps_setup` (the chunk manager's radius-6 window generated
and assembled once, a lamp set on each chunk column in one grid update,
in set-up), and renders through the program's `Renderer.render`, which
takes the general shade path for the sparse light set by its own rule;
each image comes back on the host.  The camera is the program's orbit
camera at the configuration's pose, turned to the view's yaw.
`reference` works out the same window again from the assets, the sizes
and its own copy of the lamp rule, and picks lights by the stochastic
walk (`reference/lamps.py`).
"""

from __future__ import annotations

import time

from benchmark.reference import lamps, lights, world


class LampLit:
    def __init__(self, cfg: dict, overrides: dict, device: str, phases: dict):
        from wavefront_tpu_torch.core.camera import SphericalCamera
        from wavefront_tpu_torch.headline import lamps_setup
        from wavefront_tpu_torch.kernels import _build
        from wavefront_tpu_torch.render.renderer import Renderer

        t = time.perf_counter()
        if device != "cpu":
            _build.build_all()
        phases["kernels"] = time.perf_counter() - t
        t = time.perf_counter()
        self.scene, self.chunks, settings, _, self.prefs = lamps_setup(
            cfg["width"], cfg["height"], cfg["num_bounces"], device=device,
            load_radius=cfg["load_radius"])
        settings = settings.replace(
            max_trace_steps=cfg["max_trace_steps"],
            compaction=cfg["compaction"], trace_audit=cfg["trace_audit"],
            max_nee_hits=cfg["max_nee_hits"], **overrides)
        self.prefs = self.prefs.replace(nee_type=cfg["nee_type"])
        cam = cfg["camera"]
        self.camera = SphericalCamera()
        self.camera.set_root_position(cam["root"])
        self.camera.offset = cam["offset"]
        self.camera.pitch = cam["pitch"]
        self.camera.yaw = cam["yaw"]
        self.renderer = Renderer(settings, device=device)
        phases["window"] = time.perf_counter() - t

    def frame(self, yaw: float, frame_count: int, k: int = 1):
        """One image at the view's yaw, on the host, and its audit."""
        self.camera.yaw = yaw
        basis = self.camera.eye_front_right_up()
        if k == 1:
            return self.renderer.render(self.scene, basis, self.prefs,
                                        frame_count=frame_count,
                                        with_aux=True)
        return self.renderer.render_batch(self.scene, basis, self.prefs,
                                          frame_count=frame_count, k=k,
                                          accumulate=True, with_aux=True)


# the system under test, made from the sizes, the traffic's settings
# overrides, the device, and a dict that receives set-up phases' seconds
build = LampLit


def reference(cfg: dict, assets: str, device):
    """(Reference scene, basis of a yaw) from the assets and the sizes:
    the window's terrain, its lamps and their light set."""
    blocks = world.load_blocks(assets)
    grid = world.terrain(blocks, cfg["grid_origin"], cfg["grid"], device,
                         seed=cfg["worldgen_seed"]).cpu().numpy()
    lamp = blocks.index("lamp")
    for cell in lamps.lamp_cells(grid, blocks.air):
        grid[cell] = lamp
    ref = lamps.LampReference(
        grid, cfg["grid_origin"], blocks,
        lights.light_set(grid, cfg["grid_origin"], blocks), device=device)
    cam = cfg["camera"]

    def basis(yaw: float):
        return world.orbit_basis(cam["root"], cam["offset"], yaw,
                                 cam["pitch"])

    return ref, basis

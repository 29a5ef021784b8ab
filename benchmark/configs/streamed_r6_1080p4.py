"""streamed_r6_1080p4: the program's streamed window, and its reference.

`build` makes the system under test with the program's own entry point,
`headline.streamed_setup` (the chunk manager's radius-6 window generated
and assembled once, in set-up), and renders through the program's
`Renderer`: `render` for a single frame, `render_batch(accumulate=True)`
for the mean of k frames; either returns the image on the host.  The
camera is the program's orbit camera at the configuration's pose, turned
to the view's yaw.  `reference` works out the same window again from the
assets and the sizes alone.
"""

from __future__ import annotations

import time

from benchmark.reference import lights, world
from benchmark.reference.render import Reference


class Streamed:
    def __init__(self, cfg: dict, overrides: dict, device: str, phases: dict):
        from wavefront_tpu_torch.core.camera import SphericalCamera
        from wavefront_tpu_torch.headline import streamed_setup
        from wavefront_tpu_torch.kernels import _build
        from wavefront_tpu_torch.render.renderer import Renderer

        t = time.perf_counter()
        if device != "cpu":
            _build.build_all()
        phases["kernels"] = time.perf_counter() - t
        t = time.perf_counter()
        self.scene, self.chunks, settings, _, self.prefs = streamed_setup(
            cfg["width"], cfg["height"], cfg["num_bounces"], device=device)
        settings = settings.replace(
            max_trace_steps=cfg["max_trace_steps"],
            compaction=cfg["compaction"], trace_audit=cfg["trace_audit"],
            **overrides)
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
        """One image at the view's yaw, on the host: the frame, or with
        k > 1 the mean of frames frame_count .. frame_count + k - 1; and
        its audit."""
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
build = Streamed


def reference(cfg: dict, assets: str, device):
    """(Reference scene, basis of a yaw) from the assets and the sizes:
    the window's terrain and its light set."""
    blocks = world.load_blocks(assets)
    grid = world.terrain(blocks, cfg["grid_origin"], cfg["grid"], device,
                         seed=cfg["worldgen_seed"]).cpu().numpy()
    ref = Reference(grid, cfg["grid_origin"], blocks,
                    lights.light_set(grid, cfg["grid_origin"], blocks),
                    device=device)
    cam = cfg["camera"]

    def basis(yaw: float):
        return world.orbit_basis(cam["root"], cam["offset"], yaw,
                                 cam["pitch"])

    return ref, basis

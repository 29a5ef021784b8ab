"""Pixel-range frames over several devices.

The reference is strictly single-GPU (SURVEY.md section 2: no multi-device
code anywhere).  The natural axis for a wavefront path tracer is the
ray/pixel dimension: no ray's arithmetic reads another ray, and the scene
(voxel grid, atlas, light BVH, entity pool) is read-only within a frame.

The counterpart of `wavefront_tpu.parallel.mesh`, where one jitted
program runs SPMD over a `jax.sharding.Mesh` with the ray arrays sharded.
Here a mesh is a tuple of `torch.device`: the render resolution's pixel
ids are split into contiguous ranges, one per mesh entry and as even as
the count allows (the count need not divide the pixels), and each range
runs `render.renderer.render_frame(..., pixels=(lo, hi))` on its device,
with the scene's arrays and shade tables copied there once and kept
while the arrays object stays the same.  The ranges are assembled on the
mesh's first device, which runs `postprocess` once, and the image goes
to the host.  One Python thread drives the ranges one after another, as
the JAX mesh is one controller over local devices; no
`torch.distributed` process group is involved.

Usage:
    mesh = make_mesh()                      # every visible CUDA device
    r = DistributedRenderer(settings, mesh)
    img = r.render(scene, camera_basis, prefs)
"""

from __future__ import annotations

from typing import Optional

import torch

from wavefront_tpu_torch.core.config import RenderingPreferences, RenderSettings
from wavefront_tpu_torch.kernels.shade import prep_shade_tables
from wavefront_tpu_torch.render.renderer import render_frame, render_frame_batch
from wavefront_tpu_torch.render.scene import VoxelScene
from wavefront_tpu_torch.render.wavefront import postprocess


def _device(d) -> torch.device:
    """`d` as a torch.device, a CUDA device with its index; raises for
    CUDA without a card."""
    d = torch.device(d)
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mesh: CUDA is not available; pass devices=['cpu', ...] "
                "to render on the CPU with the plain PyTorch kernels")
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(n_devices: Optional[int] = None, devices=None) -> tuple:
    """1-D mesh of devices over the pixel axis: every visible CUDA device
    (raises when there is none), or the given `devices` (a device may
    repeat: each entry renders one pixel range); the first `n_devices`
    of them when given."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device; pass devices=['cpu', ...] to "
                "render on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("make_mesh: the mesh has no device")
    return tuple(devices)


def _to(arrays, device):
    """A copy of a SceneArrays (tensors, nested NamedTuples) on `device`."""
    if isinstance(arrays, torch.Tensor):
        return arrays.to(device)
    if hasattr(arrays, "_fields"):
        return type(arrays)(*(_to(v, device) for v in arrays))
    return arrays


class DistributedRenderer:
    """Renderer running one frame as pixel ranges over a mesh
    (`make_mesh`).

    Each range is exactly `render_frame` on its pixels, so every renderer
    feature (compaction, the coherence sort, the primary cache of
    `render_batch`) behaves as on one device, and the image equals
    `Renderer.render`'s bit for bit; only a `debug_view` image, which
    paints sort slots, differs, since each range sorts its own rays."""

    def __init__(self, settings: RenderSettings, mesh):
        self.settings = settings
        self.mesh = tuple(_device(d) for d in mesh)
        if not self.mesh:
            raise ValueError("DistributedRenderer: the mesh has no device")
        self._held = {}     # device -> (source arrays, copy, shade tables)

    def ranges(self) -> list:
        """The (lo, hi) pixel-id range of each mesh entry, contiguous,
        their lengths differing by at most one."""
        n = self.settings.render_width * self.settings.render_height
        k = len(self.mesh)
        return [(n * i // k, n * (i + 1) // k) for i in range(k)]

    def _on(self, device, arrays):
        """(arrays on `device`, their shade tables), copied and built once
        for each arrays object."""
        held = self._held.get(device)
        if held is None or held[0] is not arrays:
            local = arrays if arrays.grid.device == device \
                else _to(arrays, device)
            held = (arrays, local,
                    prep_shade_tables(local.atlas_packed, local.lights))
            self._held[device] = held
        return held[1], held[2]

    def _frames(self, fn, scene, camera, prefs, **kw) -> list:
        """`fn` (render_frame or render_frame_batch) over every non-empty
        range on its device; returns the ranges' buffers."""
        prefs = prefs or RenderingPreferences()
        use_entities = (bool(scene._entities)
                        if isinstance(scene, VoxelScene) else True)
        arrays = scene.get_arrays() if isinstance(scene, VoxelScene) else scene
        parts = []
        for device, (lo, hi) in zip(self.mesh, self.ranges()):
            if lo == hi:
                continue
            local, tables = self._on(device, arrays)
            buf, _aux = fn(
                local, camera.eye, camera.front, camera.right, camera.up,
                settings=self.settings, nee_type=int(prefs.nee_type),
                sort_type=int(prefs.sort_type),
                debug_view=int(prefs.debug_view), tables=tables,
                pixels=(lo, hi), use_entities=use_entities, **kw)
            parts.append(buf)
        return parts

    def _image(self, parts):
        """The ranges assembled on the mesh's first device, postprocessed."""
        s = self.settings
        flat = torch.cat([p.to(self.mesh[0]) for p in parts])
        return postprocess(flat, s.width, s.height, s.scale)

    def render(self, scene, camera, prefs: Optional[RenderingPreferences] = None,
               frame_count: int = 0):
        """One frame; returns the (H, W, 3) numpy image."""
        parts = self._frames(render_frame, scene, camera, prefs,
                             frame_count=frame_count)
        return self._image(parts).cpu().numpy()

    def render_batch(self, scene, camera,
                     prefs: Optional[RenderingPreferences] = None,
                     frame_count: int = 0, *, k: int,
                     accumulate: bool = False):
        """k frames (frame counts frame_count .. frame_count + k - 1), each
        range through `render_frame_batch` (the first frame fills the
        primary cache under settings.cache_primary, the others reuse
        it): their mean image when `accumulate`, summed in frame order
        as `Renderer.render_batch` sums it, else (k, H, W, 3)."""
        parts = self._frames(render_frame_batch, scene, camera, prefs,
                             frame0=frame_count, k=k, accumulate=False,
                             cache_primary=self.settings.cache_primary)
        imgs = [self._image([p[i] for p in parts]) for i in range(int(k))]
        if not accumulate:
            return torch.stack(imgs).cpu().numpy()
        acc = imgs[0]
        for img in imgs[1:]:
            acc = acc + img
        return (acc / float(k)).cpu().numpy()

"""The wavefront renderer: one frame = raygen, then per bounce a coherence
sort, the compaction bucket, the tracer kernel and the fused shade kernel,
then the pixel-order restore and postprocess.

Counterpart of `wavefront_tpu.render.renderer.render_frame` and `Renderer`
on the main path of the headline frame (fused shade, dense light set,
static scene).  Radiance accumulates per ray with the throughput folded
forward (outgoing_radiance.rs:77-87), and every per-ray output is
independent of ray order, so the sort only groups rays for the kernels
and the image compares with the reference in pixel order.

Not ported yet (each raises NotImplementedError): cache_primary,
render_batch, entities, sparse light sets, the non-fused shade path,
shade_bf16, debug_stage, debug_view != 0.  The reference's TPU tracer
schedule settings (trace_tile, trace_phases*, trace_windows*, ...) are
accepted and change nothing.
"""

from __future__ import annotations

from typing import Optional

import torch

from wavefront_tpu_torch.core import vec3
from wavefront_tpu_torch.core.camera import CameraBasis
from wavefront_tpu_torch.core.config import RenderingPreferences, RenderSettings
from wavefront_tpu_torch.core.vec3 import V3
from wavefront_tpu_torch.kernels.shade import prep_shade_tables, shade_pass
from wavefront_tpu_torch.kernels.window_trace import (
    auto_events,
    coherence_key,
    window_trace,
)
from wavefront_tpu_torch.render.intersect import TRUNCATED_BIT
from wavefront_tpu_torch.render.scene import SceneArrays, VoxelScene
from wavefront_tpu_torch.render.wavefront import postprocess, raygen_soa

_F32 = torch.float32


def _check_supported(settings: RenderSettings, nee_type: int,
                     sort_type: int, debug_view: int) -> None:
    if settings.cache_primary:
        raise NotImplementedError("cache_primary is not ported yet")
    if settings.shade_fused is False:
        raise NotImplementedError("the non-fused shade path is not ported yet")
    if settings.debug_stage:
        raise NotImplementedError("debug_stage is not ported yet")
    if debug_view != 0:
        raise NotImplementedError("debug_view != 0 is not ported yet")
    if settings.shade_bf16:
        raise NotImplementedError("shade_bf16 is not ported yet")
    if nee_type not in (0, 1, 2) or sort_type not in (0, 1):
        raise ValueError(f"nee_type {nee_type} / sort_type {sort_type}")


def coherence_sort(scene: SceneArrays, o: V3, d: V3, tp: V3, rad: V3, rid):
    """One stable sort of the whole ray state by the coherence key (dead
    rays last, bit 31), replacing the reference's multi-operand sort
    network.  Returns the permuted (o, d, tp, rad, rid)."""
    gx, gy, gz = scene.grid.shape
    go = scene.grid_origin
    key = coherence_key(o.x - float(go[0]), o.y - float(go[1]),
                        o.z - float(go[2]), d.x, d.y, d.z, gx, gy, gz)
    perm = torch.sort(key, stable=True).indices

    def take(v):
        return v.map(lambda c: c[perm])

    return take(o), take(d), take(tp), take(rad), rid[perm]


def render_frame(scene: SceneArrays, eye, front, right, up, frame_count: int,
                 *, settings: RenderSettings, nee_type: int, sort_type: int,
                 debug_view: int = 0, tables=None, trace=window_trace,
                 shade=shade_pass):
    """Render one frame on the scene's device; returns ((H, W, 3) image
    tensor, aux) with aux = {"truncated", "nee_overflow"} as ints.

    tables: the scene's shade tables (prep_shade_tables), built here when
    not given.  trace / shade: the two per-bounce stages; the defaults are
    the kernels' wrappers, and `intersect.trace_plain` /
    `shade.shade_plain` (same arguments) render the frame with the plain
    versions on any device, which is how chip_smoke.py holds a whole
    frame on the card against them."""
    _check_supported(settings, nee_type, sort_type, debug_view)
    if scene.tri_active.numel() and bool(scene.tri_active.any()):
        raise NotImplementedError("dynamic entities are not ported yet")
    if nee_type != 0 and not scene.lights.dense:
        raise NotImplementedError("sparse light sets are not ported yet")
    dev = scene.grid.device
    if tables is None:
        tables = prep_shade_tables(scene.atlas_packed, scene.lights)
    w, h = settings.render_width, settings.render_height
    n = w * h
    b_total = settings.num_bounces
    gx, gy, gz = scene.grid.shape
    max_events = settings.trace_events or auto_events(gx, gy, gz)
    go = scene.grid_origin
    frame_count = int(frame_count) & 0xFFFFFFFF

    o, d, rid = raygen_soa(eye, front, right, up, w, h,
                           jitter=settings.jitter, seed=frame_count,
                           device=dev)
    tp = V3(*(torch.ones(n, dtype=_F32, device=dev) for _ in range(3)))
    rad = V3(*(torch.zeros(n, dtype=_F32, device=dev) for _ in range(3)))
    sort = settings.compaction or sort_type == 1
    trunc = torch.zeros((), dtype=torch.int64, device=dev)

    for b in range(b_total):
        if sort:
            o, d, tp, rad, rid = coherence_sort(scene, o, d, tp, rad, rid)
        m = n
        if settings.compaction:
            # smallest bucket (n, n/2, n/4) that holds every alive ray
            count = int(vec3.any_nonzero(d).sum())
            shift = int(count <= n // 2) + int(count <= n // 4)
            m = max(n >> shift, 1)

        def head(v):
            return v.map(lambda c: c[:m].contiguous())

        bo, bd = head(o), head(d)
        pa, pb, t = trace(scene, bo, bd, max_events)
        if settings.trace_audit:
            trunc = trunc + ((pa >> TRUNCATED_BIT) & 1).sum()
        inv_seed = (frame_count * b_total + b) & 0xFFFFFFFF
        no, nd, ntp, nrad = shade(
            tables, go, bo, bd, pa, pb, t, head(tp), head(rad),
            rid[:m].contiguous(), inv_seed, b, scene.lights.num_prims,
            nee_type=nee_type)
        if m < n:
            def cat(a, full):
                return V3(*(torch.cat([x, y[m:]]) for x, y in zip(a, full)))

            no, nd, ntp, nrad = cat(no, o), cat(nd, d), cat(ntp, tp), cat(nrad, rad)
        o, d, tp, rad = no, nd, ntp, nrad

    radiance = rad.stack()
    if sort:
        # restore pixel order
        out = torch.empty_like(radiance)
        out[rid.to(torch.int64)] = radiance
        radiance = out
    img = postprocess(radiance, settings.width, settings.height,
                      settings.scale)
    return img, {"truncated": int(trunc), "nee_overflow": 0}


class Renderer:
    """Host-facing renderer (reference Renderer,
    interactive_rendering.rs:396-1715): `render` runs one frame on
    `device` and returns a numpy image.

    device defaults to "cuda"; a CPU render must ask for it
    (device="cpu"), and the kernels' plain versions then run."""

    def __init__(self, settings: RenderSettings, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "Renderer: CUDA is not available; pass device='cpu' to "
                    "render with the plain PyTorch kernels")
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.settings = settings
        self._tables = None     # (scene arrays, shade tables)

    def _arrays(self, scene) -> SceneArrays:
        arrays = scene.get_arrays() if isinstance(scene, VoxelScene) else scene
        if arrays.grid.device != self.device:
            raise ValueError(
                f"scene lives on {arrays.grid.device}, renderer on "
                f"{self.device}")
        return arrays

    def render(self, scene, camera: CameraBasis,
               prefs: Optional[RenderingPreferences] = None,
               frame_count: int = 0, *, as_numpy: bool = True,
               with_aux: bool = False):
        prefs = prefs or RenderingPreferences()
        arrays = self._arrays(scene)
        if self._tables is None or self._tables[0] is not arrays:
            self._tables = (arrays, prep_shade_tables(arrays.atlas_packed,
                                                      arrays.lights))
        img, aux = render_frame(
            arrays, camera.eye, camera.front, camera.right, camera.up,
            frame_count, settings=self.settings,
            nee_type=int(prefs.nee_type), sort_type=int(prefs.sort_type),
            debug_view=int(prefs.debug_view), tables=self._tables[1],
        )
        if as_numpy:
            img = img.cpu().numpy()
        return (img, aux) if with_aux else img

    def render_batch(self, *args, **kw):
        raise NotImplementedError("render_batch is not ported yet")

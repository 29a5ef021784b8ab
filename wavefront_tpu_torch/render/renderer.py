"""The wavefront renderer: one frame = raygen, then per bounce a coherence
sort, the compaction bucket, the tracer kernel and a shade, then the
pixel-order restore and postprocess.

Counterpart of `wavefront_tpu.render.renderer.render_frame` and `Renderer`.
A bounce shades on one of two paths, chosen by `use_fused`:

  * fused: the shade kernel (`kernels/shade.py`) does the whole shade, the
    dense light pick, the dense NEE pdf sweep and the throughput/radiance
    fold in one pass; entity hits are merged into its inputs by
    `entity_attrs`, from the triangle sweep (on the card a kernel,
    `kernels/tri_sweep.py`).  It needs a dense light set within the
    kernel's caps.
  * general (`shade_m`): the same shade as plain tensor stages
    (`render/shading.py`) around the texel kernel (`kernels/texel.py`),
    with the light
    pick by `dense_sample_light` or, for sparse light sets, the stochastic
    BVH descent (on the card a kernel, `kernels/light_walk.py`), and the
    NEE pdf by the dense or the sparse sweep (on the card the sparse one
    is a kernel, `kernels/nee_sweep.py`, whose crossings and overflowing
    rays the frame reads with its audit).  It is
    what runs for `shade_fused=False`, the stage-isolation variants
    `debug_stage` "notex" / "nonee_pdf", and every light set that is
    sparse or past the fused kernel's caps (with a warning).

Radiance accumulates per ray with the throughput folded forward
(outgoing_radiance.rs:77-87), and every per-ray output is independent of
ray order, so the sort only groups rays for the kernels and the image
compares with the reference in pixel order.  (The `debug_view` image
paints ray slots, so it does depend on the sort.)

With `cache_primary`, bounce 0 runs before the loop on the raygen rays as
they are (all alive: no sort, no compaction) and its intersections go out
in aux["primary"]; handed back as `primary` they replace the bounce-0
trace (and triangle sweep) of later frames at the same pose and scene,
since intersections do not depend on the frame's seed.
`render_frame_batch` renders consecutive frames that way and returns
their mean or their stack; `Renderer` holds the cache between calls.

With `shade_bf16` the color pipeline is bfloat16 on both paths, as in the
reference: the throughput carry, reflectivity, emission, the sky and the
throughput factor (`shading.shade_rays`); geometry, alpha, metallicity,
the MIS weight and the radiance accumulation stay float32.  The sort,
the compaction and the pixel restore keep each tensor's dtype.

Three settings of the reference change what a frame does, and the port
honours them as it does:

  * `sort_bounces`: None sorts on every bounce; a tuple re-sorts on the
    bounces it names only (when compaction or sort_type 1 sort at all).
    A bounce that skips its sort traces the rays in the order of the last
    sort, and its compaction bucket covers the last alive slot, not the
    alive count (`compaction_bucket`).  The image does not change.
  * `trace_skips`: False hands the tracer the aux grid with its
    empty-space distances cleared (`aux_grid & 3`), so it marches every
    voxel boundary.  The image does not change.
  * `trace_presort`: True (the default) keys the bounce sort on the
    tracer's coherence key, the counterpart of the reference's hoisted
    presort; False keys it as the reference's non-hoisted sort does:
    `morton_key_3d_soa(o) >> 1` for sort_type 1, else 0, with bit 31 set
    on dead rays under compaction (`bounce_sort_key`).

The reference's other tracer settings are accepted and change nothing:
`trace_tile`, `trace_unroll`, `trace_phases`, `trace_phase_events`,
`trace_phases_at`, `trace_windows` and `trace_windows_hot` schedule the
TPU kernel's tiles, phases and resident 32^3 windows, and the CUDA tracer
walks one ray a thread with no tiles or windows; `trace_skip_stride`
alternates the TPU kernel's lean and full event forms, which the CUDA
march does not have; `trace_wskip` turns off a skip of whole empty
windows, and the port's aux grid has no whole-window skip;
`use_column_trace=False` picks the reference's XLA DDA, whose counterpart
here is the tracer's plain version, which the card's path never runs.
"""

from __future__ import annotations

import warnings
from typing import Optional

import torch

from wavefront_tpu_torch.core import morton, rng, vec3
from wavefront_tpu_torch.core.camera import CameraBasis
from wavefront_tpu_torch.core.config import (
    EPSILON_BLOCK,
    T_MAX,
    RenderingPreferences,
    RenderSettings,
)
from wavefront_tpu_torch.core.vec3 import V3
from wavefront_tpu_torch.kernels.ray_sort import ray_key, ray_permute
from wavefront_tpu_torch.kernels.shade import (
    MAX_NODES,
    MAX_PRIMS,
    prep_shade_tables,
    shade_pass,
)
from wavefront_tpu_torch.kernels.texel import texel_fetch, texel_index
from wavefront_tpu_torch.kernels.tri_sweep import entity_stream
from wavefront_tpu_torch.kernels.window_trace import auto_events, window_trace
from wavefront_tpu_torch.render.intersect import (
    TRUNCATED_BIT,
    TriHit,
    VoxelHit,
    pack_hits,
    triangle_sweep,
    unpack_hits,
)
from wavefront_tpu_torch.render.scene import SceneArrays, VoxelScene
from wavefront_tpu_torch.render.shading import (
    CHANNELS,
    EntityHit,
    color_dtype,
    shade_rays,
    throughput_factor,
)
from wavefront_tpu_torch.render.wavefront import (
    dense_sample_light,
    nee_pdf_sweep,
    postprocess,
    raygen_soa,
    traverse_light_bvh,
)
from wavefront_tpu_torch.utils import spans
from wavefront_tpu_torch.utils.spans import span

_F32 = torch.float32
_I32 = torch.int32


def _check_supported(settings: RenderSettings, nee_type: int,
                     sort_type: int) -> None:
    if settings.debug_stage not in ("", "freetrace", "notex", "nonee_pdf"):
        raise ValueError(f"debug_stage {settings.debug_stage!r}")
    if nee_type not in (0, 1, 2) or sort_type not in (0, 1):
        raise ValueError(f"nee_type {nee_type} / sort_type {sort_type}")


def use_fused(scene: SceneArrays, settings: RenderSettings,
              nee_type: int) -> bool:
    """Whether the fused shade kernel drives this frame.  `shade_fused`
    None means fused.  The stage-isolation variants the kernel cannot
    express take the general path, and so does, with a warning, a light
    set that is sparse or past the kernel's table caps."""
    if settings.shade_fused is False:
        return False
    if settings.debug_stage in ("notex", "nonee_pdf"):
        return False
    if nee_type != 0:
        la = scene.lights
        m, p = la.node_min.shape[0], la.p0.shape[0]
        if not la.dense or m > MAX_NODES or p > MAX_PRIMS:
            warnings.warn(
                "light set exceeds the fused-shade caps "
                f"(nodes {m}/{MAX_NODES}, prims {p}/{MAX_PRIMS}, "
                f"dense={la.dense}) — falling back to the general shade path",
                stacklevel=2,
            )
            return False
    return True


def bounce_sort_key(scene: SceneArrays, settings: RenderSettings,
                    sort_type: int, o: V3, d: V3):
    """Key of the bounce sort.  trace_presort (the default): the tracer's
    coherence key shifted right by 5, as int32 (`kernels/ray_sort.py::
    ray_key`: dead rays last, at bit 26).  Otherwise the reference's
    non-hoisted key (wavefront_tpu/render/renderer.py:797-806), int64
    holding an unsigned 32-bit value: the morton key of the origin
    shifted right by one for sort_type 1, else 0, and bit 31 on dead rays
    under compaction."""
    if settings.trace_presort:
        return ray_key(o, d, scene.grid_origin, scene.grid.shape)
    if sort_type == 1:
        key = morton.morton_key_3d_soa(o.x, o.y, o.z) >> 1
    else:
        key = torch.zeros(o.x.shape, dtype=torch.int64, device=o.x.device)
    if settings.compaction:
        key = key | ((~vec3.any_nonzero(d)).to(torch.int64) << 31)
    return key


def coherence_sort(scene: SceneArrays, o: V3, d: V3, tp: V3, rad: V3, rid,
                   *riders: V3, key=None):
    """One stable sort of the whole ray state, replacing the reference's
    multi-operand sort network: by `key` (`bounce_sort_key`, either
    dtype), or when it is None by the coherence key (dead rays last).
    One permute (`kernels/ray_sort.py::ray_permute`) moves every
    component, so at most one rider fits.  Returns the permuted (o, d,
    tp, rad, rid, *riders)."""
    if key is None:
        key = ray_key(o, d, scene.grid_origin, scene.grid.shape)
    perm = torch.sort(key, stable=True).indices
    vecs = (o, d, tp, rad, *riders)
    cols = ray_permute(perm, [c for v in vecs for c in v] + [rid])
    out = [V3(*cols[3 * i:3 * i + 3]) for i in range(len(vecs))]
    return (*out[:4], cols[-1], *out[4:])


def compaction_bucket(alive, sorted_now: bool):
    """Rays the bounce traces and shades under compaction: the smallest of
    n, n/2 and n/4 (at least 1) that holds every alive ray.  Right after a
    sort the alive rays lead, so their count decides; on a bounce that
    skipped its sort they keep their slots, so the last alive slot decides
    (n - argmax(alive[::-1]) in the reference, 0 when none is alive).
    alive: (n,) bool.  Returns the bucket and the alive rays' count, or
    None where the bucket came from the last alive slot.  The count is a
    host sync (`sync.compaction_count`)."""
    n = alive.shape[0]
    if sorted_now:
        with spans.host_sync("sync.compaction_count"):
            count = int(alive.sum())
    else:
        slot = torch.arange(1, n + 1, dtype=torch.int64, device=alive.device)
        with spans.host_sync("sync.compaction_count"):
            count = int(torch.where(alive, slot, 0).max())
    shift = int(count <= n // 2) + int(count <= n // 4)
    return max(n >> shift, 1), (count if sorted_now else None)


def _freetrace_hit(scene: SceneArrays, origin: V3, direction: V3,
                   alive) -> VoxelHit:
    """Stage-isolation synthetic constant hit (debug_stage="freetrace"):
    every ray stays alive through every bounce, so the frame time is that
    of the pipeline without the tracer."""
    n = origin.x.shape[0]
    dev = origin.x.device
    t5 = torch.full((n,), 5.0, dtype=_F32, device=dev)
    go = scene.grid_origin
    hp = origin + direction * t5

    def cell(c, g, off):
        return ((c - float(g)).to(_I32) - off).clamp(0, 10 ** 6)

    return VoxelHit(
        hit=alive, t=t5,
        owner=torch.ones(n, dtype=_I32, device=dev),
        face=torch.full((n,), 3, dtype=_I32, device=dev),
        vx=cell(hp.x, go[0], 0), vy=cell(hp.y, go[1], 1),
        vz=cell(hp.z, go[2], 0), entered=alive,
    )


def _entity_frame(scene: SceneArrays, tri: TriHit):
    """Shading attributes of each ray's winning entity triangle (reference
    raytrace.rs:541-566): (normal, tangent, bitangent, u, v, texture) with
    the frame from the triangle's edges and barycentric uv."""
    tv = scene.tri_verts[tri.tri]                      # (N, 3, 3)
    e1 = V3.from_array(tv[:, 1] - tv[:, 0])
    e2 = V3.from_array(tv[:, 2] - tv[:, 0])
    normal = vec3.cross(e1, e2)
    normal = normal / vec3.norm(normal).clamp_min(1e-20)
    tangent = e1 / vec3.norm(e1).clamp_min(1e-20)
    bitangent = vec3.cross(normal, tangent)
    bitangent = bitangent / vec3.norm(bitangent).clamp_min(1e-20)
    uv = scene.tri_uv[tri.tri]                         # (N, 3, 2)
    b0 = 1.0 - tri.bary_u - tri.bary_v
    u = (uv[:, 0, 0] * b0 + uv[:, 1, 0] * tri.bary_u) + uv[:, 2, 0] * tri.bary_v
    v = (uv[:, 0, 1] * b0 + uv[:, 1, 1] * tri.bary_u) + uv[:, 2, 1] * tri.bary_v
    return normal, tangent, bitangent, u, v, scene.tri_tex[tri.tri]


def entity_attrs(scene: SceneArrays, origin: V3, direction: V3, pa, t,
                 counts=None):
    """Closest-hit merge of the entity triangles into the tracer's hits,
    for the fused shade: returns (merged t, tri_attrs), the 12-tensor
    stream of `kernels.shade.shade_pass`.  counts: `triangle_sweep`'s.
    CUDA tensors launch the triangle sweep's kernel in its stream form
    (`kernels/tri_sweep.py::entity_stream`: one launch, whose 11 float
    words are 0 where no entity wins, the lanes K2 does not read them),
    CPU tensors take `entity_attrs_plain`."""
    if origin.x.device.type == "cuda":
        return entity_stream(
            scene.tri_verts.contiguous(), scene.tri_active.contiguous(),
            scene.tri_uv.contiguous(), scene.tri_tex.contiguous(),
            scene.atlas_packed.shape[0],
            *(V3(*(c.contiguous() for c in v)) for v in (origin, direction)),
            pa.contiguous(), t.contiguous(), EPSILON_BLOCK, T_MAX, counts)
    return entity_attrs_plain(scene, origin, direction, pa, t, counts)


def entity_attrs_plain(scene: SceneArrays, origin: V3, direction: V3, pa,
                       t, counts=None):
    """Plain PyTorch version of `entity_attrs` (same arguments), on any
    device: the triangle sweep, then the merge and the stream as tensor
    ops."""
    tri = triangle_sweep(scene.tri_verts, scene.tri_active, origin, direction,
                         counts=counts)
    use_tri = tri.hit & vec3.any_nonzero(direction) & (
        ((pa & 1) == 0) | (tri.t < t))
    normal, tangent, bitangent, u, v, tex = _entity_frame(scene, tri)
    tex = tex.clamp(0, scene.atlas_packed.shape[0] - 1)
    tflag = tex | (use_tri.to(_I32) << 16)
    return torch.where(use_tri, tri.t, t), (
        *normal, *tangent, *bitangent, u, v, tflag)


def shade_m(scene: SceneArrays, settings: RenderSettings, nee_type: int,
            bounce: int, origin: V3, direction: V3, rid, inv_seed: int,
            vox: VoxelHit, use_entities: bool, texel=texel_fetch,
            tri: Optional[TriHit] = None, counts=None, tri_counts=None):
    """General shade plus NEE pdf of one (possibly compacted) ray block:
    `shading.shade_rays` around the texel kernel (span `render.texel`),
    the light pick by `dense_sample_light` or the BVH descent (span
    `render.light_pick`), then the dense or sparse pdf sweep (span
    `render.nee_pdf`, its reverse walk included).  `tri`: the block's
    entity hits when the caller holds them (the primary cache), else the
    triangle sweep runs here.  counts: the (2,) int64 device tensor the
    sparse sweep adds its crossings and overflowing rays to (required on
    a sparse light set with NEE; the caller reads it); tri_counts: the
    triangle sweep's (`triangle_sweep`'s counts).

    Returns the next ray, the block's emission and its throughput factor
    (`shading.throughput_factor`), both in the color dtype
    (settings.shade_bf16), and the entity hits used (None without
    entities)."""
    lights = scene.lights
    atlas = scene.atlas_packed
    entity = None
    if not use_entities:
        tri = None
    else:
        if tri is None:
            tri = triangle_sweep(scene.tri_verts, scene.tri_active, origin,
                                 direction, counts=tri_counts)
        use_tri = tri.hit & (~vox.hit | (tri.t < vox.t))
        entity = EntityHit(use_tri, *_entity_frame(scene, tri))
        vox = vox._replace(hit=vox.hit | tri.hit,
                           t=torch.where(use_tri, tri.t, vox.t))

    def fetch(tex, u, v):
        if settings.debug_stage == "notex":
            # stage-isolation variant: a constant texel, no atlas read
            return [torch.full_like(u, 0.5) * (u * 0 + 1)] * len(CHANNELS)
        with span("render.texel"):
            if settings.shade_texel_kernel:
                return texel(atlas, tex.to(_I32).contiguous(), u, v,
                             channels=CHANNELS)
            # the caller asked for PyTorch's indexed read instead of the
            # kernel
            tx = atlas[texel_index(atlas, tex, u, v)]
            return [tx[:, c] for c in CHANNELS]

    def pick(point, normal, seed, active):
        with span("render.light_pick"):
            if lights.dense:
                return dense_sample_light(lights, point, normal, seed,
                                          active)
            return traverse_light_bvh(lights, point, normal, seed, active,
                                      settings.max_bvh_depth), None

    # the frame's seed, a Python int, copied to the device: a blocking copy
    with spans.host_sync("sync.seed"):
        seed = rng.combine(inv_seed, rid)
    (new_o, new_d, normal, emis, refl, mis, bsdf_pdf,
     dense_probs) = shade_rays(scene.grid_origin, lights, nee_type, bounce,
                               origin, direction, seed, vox, entity,
                               fetch, pick,
                               color_bf16=settings.shade_bf16)
    if nee_type == 0:
        nee_pdf = torch.zeros_like(mis)
    elif settings.debug_stage == "nonee_pdf":
        # stage-isolation variant: sampling runs, the sweep is elided
        nee_pdf = mis * 0.0
    else:
        with span("render.nee_pdf"):
            nee_pdf = nee_pdf_sweep(
                lights, new_o, normal, new_d, mis, dense_probs,
                max_depth=settings.max_bvh_depth,
                max_hits=settings.max_nee_hits, counts=counts)
    return (new_o, new_d, emis,
            throughput_factor(new_d, refl, mis, bsdf_pdf, nee_pdf), tri)


def _bounce_dbg(m: int, on: bool, device) -> V3:
    """Ray-layout visualization (reference raytrace.rs:496-523): on bounce
    1 every ray slot is painted with its deinterleaved 2-D position."""
    zero = torch.zeros(m, dtype=_F32, device=device)
    if not on:
        return V3(zero, zero, zero)
    di, dj = morton.deinterleave_bits_2(torch.arange(m, device=device))
    return V3(di.to(_F32) / 1023.0, dj.to(_F32) / 1023.0, zero)


def render_frame(scene: SceneArrays, eye, front, right, up, frame_count: int,
                 primary=None, *, settings: RenderSettings, nee_type: int,
                 sort_type: int, debug_view: int = 0,
                 cache_primary: bool = False, tables=None,
                 trace=window_trace, shade=shade_pass, texel=texel_fetch,
                 pixels=None, use_entities: bool = True):
    """Render one frame on the scene's device; returns ((H, W, 3) image
    tensor, aux) with aux = {"truncated", "nee_overflow"} as ints (both 0
    unless settings.trace_audit).

    use_entities: resolve the entity triangles' hits (the triangle sweep
    and the entity stream into the shade).  False drops them even when
    the pool has live triangles; True with no live triangle renders the
    image of False.  The caller decides it from host state (`Renderer`
    passes `bool(scene._entities)` for a VoxelScene), so no device read
    picks the path.

    pixels: (lo, hi) renders the pixel ids lo <= id < hi of the render
    resolution only (id = y * render_width + x), and returns in place of
    the image that range's (hi - lo, 3) float32 buffer in id order, the
    one `postprocess` reads (the radiance, or the debug buffer when
    debug_view is on); the caller assembles the ranges and runs
    `postprocess` once (`parallel/mesh.py`).  Every draw is seeded by the
    global id, so a range's pixels equal the whole frame's: only which
    rays share a sort, a compaction bucket and a launch changes.

    cache_primary: run bounce 0 on the raygen rays as they are (no sort,
    no compaction) and add its intersections as aux["primary"]:
    (pa, pb, t, tri_attrs) on the fused path, (VoxelHit, TriHit or None)
    on the general one.  primary: such intersections from an earlier frame
    at the same pose and scene; they replace this frame's bounce-0 trace
    and triangle sweep (cache_primary must be on).

    tables: the scene's shade tables (prep_shade_tables), built here when
    the fused path needs them and they are not given.  trace / shade /
    texel: the per-bounce kernels' wrappers;
    `intersect.trace_plain`, `shade.shade_plain` and `texel.texel_plain`
    (same arguments) render the frame with the plain versions on any
    device, which is how the card tests hold a whole frame on the card
    against them."""
    with span("render.frame", frame_count):
        _check_supported(settings, nee_type, sort_type)
        if primary is not None and not cache_primary:
            raise ValueError("render_frame: primary hits need cache_primary")
        dev = scene.grid.device
        fused = use_fused(scene, settings, nee_type)
        if fused and tables is None:
            tables = prep_shade_tables(scene.atlas_packed, scene.lights)
        w, h = settings.render_width, settings.render_height
        lo, hi = (0, w * h) if pixels is None else (int(pixels[0]),
                                                    int(pixels[1]))
        if not 0 <= lo < hi <= w * h:
            raise ValueError(f"render_frame: pixels {pixels} outside "
                             f"[0, {w * h})")
        n = hi - lo
        b_total = settings.num_bounces
        gx, gy, gz = scene.grid.shape
        max_events = settings.trace_events or auto_events(gx, gy, gz)
        go = scene.grid_origin
        frame_count = int(frame_count) & 0xFFFFFFFF
        freetrace = settings.debug_stage == "freetrace"

        with span("render.raygen"):
            o, d, rid = raygen_soa(eye, front, right, up, w, h,
                                   jitter=settings.jitter, seed=frame_count,
                                   device=dev, pixels=(lo, hi))
            # path throughput in the color dtype, radiance in float32
            tp = V3(*(torch.ones(n, dtype=color_dtype(settings.shade_bf16),
                                 device=dev) for _ in range(3)))
            rad = V3(*(torch.zeros(n, dtype=_F32, device=dev)
                       for _ in range(3)))
            # the debug buffer rides the sort only when it is shown
            dbg = V3(*(torch.zeros(n, dtype=_F32, device=dev)
                       for _ in range(3))) if debug_view else None
        sort = settings.compaction or sort_type == 1
        sort_set = None if settings.sort_bounces is None else {
            int(i) for i in settings.sort_bounces}
        # the tracer's scene: without its empty-space skips when asked
        tscene = scene if settings.trace_skips else scene._replace(
            aux_grid=scene.aux_grid & 3)
        trunc = torch.zeros((), dtype=torch.int64, device=dev)
        # the sparse NEE sweep's crossings and overflowing rays and the
        # active entity triangles swept, read with the audit
        sparse_nee = not (fused or nee_type == 0 or scene.lights.dense)
        counts = torch.zeros(3, dtype=torch.int64, device=dev) \
            if sparse_nee or use_entities else None
        nee_counts = counts[:2] if sparse_nee else None
        tri_counts = counts[2:] if use_entities else None
        hits0 = None

        for b in range(b_total):
            with span("render.bounce", b):
                # the cached bounce: every ray alive and in pixel order
                outside = cache_primary and b == 0
                cached = primary if outside else None
                sort_now = sort and not outside and (sort_set is None
                                                     or b in sort_set)
                if sort_now:
                    with span("render.sort_key"):
                        key = bounce_sort_key(scene, settings, sort_type, o, d)
                    with span("render.permute"):
                        if dbg is None:
                            o, d, tp, rad, rid = coherence_sort(
                                scene, o, d, tp, rad, rid, key=key)
                        else:
                            o, d, tp, rad, rid, dbg = coherence_sort(
                                scene, o, d, tp, rad, rid, dbg, key=key)
                m, alive_n = n, None
                compact = settings.compaction and not outside

                def head(v):
                    return v.map(lambda c: c[:m].contiguous())

                with span("render.compact"):
                    if compact:
                        m, alive_n = compaction_bucket(vec3.any_nonzero(d),
                                                       sort_now)
                    bo, bd, btp, brad = head(o), head(d), head(tp), head(rad)
                    brid = rid[:m].contiguous()
                if b == 0:
                    # the raygen rays (or the primary cache's), all alive
                    alive_n = m
                if alive_n is not None:
                    spans.count_lanes(m, alive_n)
                inv_seed = (frame_count * b_total + b) & 0xFFFFFFFF
                with span("render.k1_trace"):
                    if cached is None and freetrace:
                        vox = _freetrace_hit(scene, bo, bd,
                                             vec3.any_nonzero(bd))
                    elif cached is None:
                        pa, pb, t = trace(tscene, bo, bd, max_events)
                if cached is None and not freetrace and settings.trace_audit:
                    trunc = trunc + ((pa >> TRUNCATED_BIT) & 1).sum()
                if fused:
                    if cached is not None:
                        pa, pb, t, tri_attrs = cached
                    else:
                        if freetrace:
                            pa, pb, t = pack_hits(vox)
                        tri_attrs = None
                        if use_entities:
                            with span("render.entities"):
                                t, tri_attrs = entity_attrs(scene, bo, bd, pa,
                                                            t, tri_counts)
                    if outside:
                        hits0 = cached or (pa, pb, t, tri_attrs)
                    with span("render.k2_shade"):
                        no, nd, ntp, nrad = shade(
                            tables, go, bo, bd, pa, pb, t, btp, brad, brid,
                            inv_seed, b, scene.lights.num_prims,
                            nee_type=nee_type, tri_attrs=tri_attrs,
                            color_bf16=settings.shade_bf16)
                else:
                    with span("render.shade"):
                        tri = None
                        if cached is not None:
                            vox, tri = cached
                        elif not freetrace:
                            vox = unpack_hits(pa, pb, t)
                        no, nd, emis, tpf, tri = shade_m(
                            scene, settings, nee_type, b, bo, bd, brid,
                            inv_seed, vox, use_entities, texel, tri,
                            nee_counts, tri_counts)
                        if outside:
                            hits0 = cached or (vox, tri)
                        nrad = brad + btp * emis
                        ntp = btp * tpf
                ndbg = None if dbg is None \
                    else head(dbg) + _bounce_dbg(m, b == 1, dev)
                if m < n:
                    def cat(a, full):
                        return V3(*(torch.cat([x, y[m:]])
                                    for x, y in zip(a, full)))

                    with span("render.merge"):
                        no, nd = cat(no, o), cat(nd, d)
                        ntp, nrad = cat(ntp, tp), cat(nrad, rad)
                        if dbg is not None:
                            ndbg = cat(ndbg, dbg)
                o, d, tp, rad, dbg = no, nd, ntp, nrad, ndbg

        def pixel_order(v: V3):
            a = v.stack()
            if not sort:
                return a
            out = torch.empty_like(a)
            slot = rid.to(torch.int64)
            out[slot - lo if lo else slot] = a
            return out

        with spans.host_sync("sync.audit"):
            if counts is None:
                truncated, crossings, overflow, swept = int(trunc), 0, 0, 0
            else:
                truncated, crossings, overflow, swept = torch.cat(
                    [trunc.view(1), counts]).tolist()
        spans.count_crossings(crossings)
        spans.count_entity_tris(swept)
        aux = {"truncated": truncated,
               "nee_overflow": overflow if settings.trace_audit else 0}
        if pixels is not None:
            with span("render.restore"):
                img = pixel_order(rad if dbg is None else dbg)
        else:
            with span("render.restore"):
                rad_px = pixel_order(rad)
                dbg_px = None if dbg is None else pixel_order(dbg)
            with span("render.postprocess"):
                img = postprocess(rad_px, settings.width, settings.height,
                                  settings.scale, debug=dbg_px,
                                  debug_view=debug_view)
        if cache_primary:
            aux["primary"] = hits0
        return img, aux


def render_frame_batch(scene: SceneArrays, eye, front, right, up, frame0: int,
                       primary=None, *, k: int, accumulate: bool,
                       cache_primary: bool = False, **frame_kw):
    """Render k consecutive frames (frame counts frame0 .. frame0 + k - 1)
    at one pose; returns (their mean image when `accumulate`, summed in
    frame order, else the (k, H, W, 3) stack; aux).  Counterpart of the
    reference's `render_frame_batch`, as a loop: a frame is a sequence of
    launches here, not one compiled program.

    cache_primary: the first frame fills the primary-hit cache when no
    `primary` is given and the others reuse it; aux["primary"] hands it
    out for a later batch at the same pose.  aux also sums the frames'
    "truncated" and "nee_overflow".  frame_kw: render_frame's keywords."""
    if int(k) < 1:
        raise ValueError(f"render_frame_batch: k {k} is not positive")
    frame0 = int(frame0) & 0xFFFFFFFF
    aux = {"truncated": 0, "nee_overflow": 0}
    imgs, acc = [], None
    for i in range(int(k)):
        img, a = render_frame(scene, eye, front, right, up, frame0 + i,
                              primary, cache_primary=cache_primary,
                              **frame_kw)
        if cache_primary and primary is None:
            primary = a["primary"]
        aux["truncated"] += a["truncated"]
        aux["nee_overflow"] += a["nee_overflow"]
        if not accumulate:
            imgs.append(img)
        else:
            acc = img if acc is None else acc + img
    aux["primary"] = primary
    return (acc / float(k) if accumulate else torch.stack(imgs)), aux


class Renderer:
    """Host-facing renderer (reference Renderer,
    interactive_rendering.rs:396-1715): `render` runs one frame on
    `device` and returns a numpy image; `render_batch` runs k.

    device defaults to "cuda"; a CPU render must ask for it
    (device="cpu"), and the kernels' plain versions then run.

    With settings.cache_primary (and no jitter) the renderer keeps the
    bounce-0 intersections of the last pose it rendered and reuses them
    while the scene arrays, the camera basis and the mode stay the same
    (every edit of a VoxelScene gives new arrays)."""

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
        self._tables = None     # (atlas, lights, shade tables)
        self._primary = None    # (scene arrays, pose and mode, hits)

    def _arrays(self, scene) -> SceneArrays:
        arrays = scene.get_arrays() if isinstance(scene, VoxelScene) else scene
        if arrays.grid.device != self.device:
            raise ValueError(
                f"scene lives on {arrays.grid.device}, renderer on "
                f"{self.device}")
        return arrays

    def _frame_args(self, scene, camera: CameraBasis, prefs):
        """(arrays, render_frame's keywords, the primary cache's key or
        None, the cached primary hits or None) of one call."""
        prefs = prefs or RenderingPreferences()
        arrays = self._arrays(scene)
        # the shade tables depend on the atlas and the lights alone, which
        # a block edit or an entity move keeps in its new arrays
        kept = self._tables
        if kept is None or kept[0] is not arrays.atlas_packed \
                or kept[1] is not arrays.lights:
            self._tables = (
                arrays.atlas_packed, arrays.lights,
                prep_shade_tables(arrays.atlas_packed, arrays.lights))
        # entity-less scenes skip the triangle sweep, decided on the host
        use_entities = (bool(scene._entities)
                        if isinstance(scene, VoxelScene) else True)
        mode = (int(prefs.nee_type), int(prefs.sort_type),
                int(prefs.debug_view), use_entities)
        kw = dict(settings=self.settings, nee_type=mode[0], sort_type=mode[1],
                  debug_view=mode[2], use_entities=use_entities,
                  tables=self._tables[2],
                  cache_primary=self.settings.cache_primary)
        pkey = primary = None
        if self.settings.cache_primary and self.settings.jitter == 0.0:
            pkey = (*(tuple(float(x) for x in v) for v in (
                camera.eye, camera.front, camera.right, camera.up)), mode)
            held = self._primary
            if held is not None and held[0] is arrays and held[1] == pkey:
                primary = held[2]
        return arrays, kw, pkey, primary

    def _keep_primary(self, arrays, pkey, primary, aux) -> None:
        if pkey is not None and primary is None \
                and aux.get("primary") is not None:
            self._primary = (arrays, pkey, aux["primary"])

    def render(self, scene, camera: CameraBasis,
               prefs: Optional[RenderingPreferences] = None,
               frame_count: int = 0, *, as_numpy: bool = True,
               with_aux: bool = False):
        with span("renderer.render"):
            with span("renderer.prepare"):
                arrays, kw, pkey, primary = self._frame_args(scene, camera,
                                                             prefs)
            img, aux = render_frame(
                arrays, camera.eye, camera.front, camera.right, camera.up,
                frame_count, primary, **kw)
            self._keep_primary(arrays, pkey, primary, aux)
            if as_numpy:
                with spans.host_sync("sync.image_copy"):
                    img = img.cpu().numpy()
        return (img, aux) if with_aux else img

    def render_batch(self, scene, camera: CameraBasis,
                     prefs: Optional[RenderingPreferences] = None,
                     frame_count: int = 0, *, k: int,
                     accumulate: bool = False, as_numpy: bool = True,
                     with_aux: bool = False):
        """k frames (frame counts frame_count .. frame_count + k - 1): the
        mean image when `accumulate`, else (k, H, W, 3).  Equal bit for
        bit to k successive `render` calls of a renderer with the same
        settings."""
        with span("renderer.batch", k):
            with span("renderer.prepare"):
                arrays, kw, pkey, primary = self._frame_args(scene, camera,
                                                             prefs)
            img, aux = render_frame_batch(
                arrays, camera.eye, camera.front, camera.right, camera.up,
                frame_count, primary, k=k, accumulate=accumulate, **kw)
            self._keep_primary(arrays, pkey, primary, aux)
            if as_numpy:
                with spans.host_sync("sync.image_copy"):
                    img = img.cpu().numpy()
        return (img, aux) if with_aux else img

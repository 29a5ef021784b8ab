"""The shade and sample step of one bounce, as plain tensor stages.

One implementation serves both shade paths: the renderer's general path
(`render.renderer.shade_m`) runs it around the texel kernel with the
light pick and NEE pdf of `render.wavefront`, and the fused shade kernel's
plain version (`kernels.shade.shade_plain`) runs it with the kernel-order
dense light pick and pdf sweep.  What differs between the two comes in as
the `fetch` and `pick` callables.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from wavefront_tpu_torch.core import rng, vec3
from wavefront_tpu_torch.core.config import (
    EMISSION_SCALE,
    EPSILON_BLOCK,
    MISS_DISTANCE,
    NEE_MIS_WEIGHT,
    SKY_COS_CUTOFF,
    SKY_EMISSION,
)
from wavefront_tpu_torch.core.vec3 import V3
from wavefront_tpu_torch.render.intersect import VoxelHit
from wavefront_tpu_torch.render.wavefront import (
    BvhSample,
    cosine_hemisphere,
    reflect,
)

_F32 = torch.float32
_INV_PI = float(np.float32(1.0 / math.pi))
_EPS15 = float(np.float32(EPSILON_BLOCK * 1.5))

# the 8 packed-atlas channels the shade reads: reflectivity rgb, alpha,
# emissivity rgb, metallicity
CHANNELS = (0, 1, 2, 3, 4, 5, 6, 8)


def color_dtype(bf16: bool) -> torch.dtype:
    """The dtype of the throughput and the shade's colors: bfloat16 in
    the bf16 color pipeline (settings.shade_bf16), else float32."""
    return torch.bfloat16 if bf16 else _F32


class EntityHit(NamedTuple):
    """Per ray, the winning entity triangle's shading attributes, taken
    over the voxel face's where `use` is set."""

    use: torch.Tensor      # (N,) bool: the triangle is the closest hit
    normal: V3
    tangent: V3
    bitangent: V3
    u: torch.Tensor        # (N,) f32
    v: torch.Tensor
    tex: torch.Tensor      # (N,) int texture slot


def shade_rays(grid_origin, lights, nee_type: int, bounce: int, origin: V3,
               direction: V3, seed, vox: VoxelHit, entity, fetch, pick,
               color_bf16: bool = False):
    """Shade and sample every ray (reference raytrace.rs:467-694).

    vox: the closest hits, entity hits merged in (`hit` set and `t` the
    triangle's where `entity.use`); entity: EntityHit or None.
    lights: the light prims' p0, e1, e2 (P, 3) and is_tri (P,) bool.
    seed: per-ray murmur3 state (invocation seed combined with the pixel
    id).  fetch(tex, u, v): the 8 `CHANNELS` of each ray's texel.
    pick(point, normal, seed, active): (BvhSample, dense prim
    probabilities or None), called when nee_type is not 0.
    color_bf16: the bf16 color pipeline (settings.shade_bf16):
    reflectivity, emission and the sky are bfloat16, rounded where the
    reference rounds them (the texels after the fetch, cos_in before the
    emission product, each product in bfloat16); alpha and metallicity
    (they gate the murmur3 comparisons), geometry, the MIS weight and the
    bsdf pdf stay float32.

    Returns (new origin V3, new direction V3, normal V3, emissivity V3,
    reflectivity V3, MIS weight, bsdf pdf, what `pick` gave second)."""
    n = origin.x.shape[0]
    dev = origin.x.device
    alive = vec3.any_nonzero(direction)
    zero = torch.zeros(n, dtype=_F32, device=dev)
    one = torch.ones(n, dtype=_F32, device=dev)
    hit_any = vox.hit & alive
    hit_point = origin + direction * vox.t

    # ---- voxel face attributes ----
    face = vox.face
    axis = face >> 1                        # 0:x 1:y 2:z
    signf = ((face & 1) * 2 - 1).to(_F32)   # outward
    normal = V3(torch.where(axis == 0, signf, zero),
                torch.where(axis == 1, signf, zero),
                torch.where(axis == 2, signf, zero))
    # canonical tangent = next axis in the xyz cycle
    tangent = V3(torch.where(axis == 2, one, zero),
                 torch.where(axis == 0, one, zero),
                 torch.where(axis == 1, one, zero))
    bitangent = vec3.cross(normal, tangent)
    go = grid_origin
    lx = hit_point.x - (vox.vx + go[0]).to(_F32)
    ly = hit_point.y - (vox.vy + go[1]).to(_F32)
    lz = hit_point.z - (vox.vz + go[2]).to(_F32)
    # face-local uv from the mesher's per-vertex assignment
    # (chunk.rs:222-287): 0: (1-lz, 1-ly)  1: (lz, 1-ly)  2: (lx, lz)
    #                     3: (1-lx, lz)    4: (lx, 1-ly)  5: (1-lx, 1-ly)
    u = torch.where(face == 0, 1.0 - lz, torch.where(
        face == 1, lz, torch.where(face == 2, lx, torch.where(
            face == 3, 1.0 - lx, torch.where(face == 4, lx, 1.0 - lx)))))
    v = torch.where((face == 2) | (face == 3), lz, 1.0 - ly)
    # texture slot = block*6 + face (block.rs:116-119); the fetch clamps
    # it (miss lanes carry the out-of-table air id)
    tex = vox.owner * 6 + face

    if entity is not None:
        normal = vec3.where(entity.use, entity.normal, normal)
        tangent = vec3.where(entity.use, entity.tangent, tangent)
        bitangent = vec3.where(entity.use, entity.bitangent, bitangent)
        u = torch.where(entity.use, entity.u, u)
        v = torch.where(entity.use, entity.v, v)
        tex = torch.where(entity.use, entity.tex.to(tex.dtype), tex)

    # ---- texels: the 8 consumed channels of the packed atlas ----
    ch = fetch(tex, u, v)
    cdt = color_dtype(color_bf16)
    reflectivity = V3(ch[0].to(cdt), ch[1].to(cdt), ch[2].to(cdt))
    alpha, metallicity = ch[3], ch[7]
    cos_c = (-vec3.dot(direction, normal)).to(cdt)
    emissivity = V3(EMISSION_SCALE * ch[4].to(cdt) * cos_c,
                    EMISSION_SCALE * ch[5].to(cdt) * cos_c,
                    EMISSION_SCALE * ch[6].to(cdt) * cos_c)

    # ---- scatter decision (reference raytrace.rs:588-603) ----
    scatter_rand = rng.finalizef(rng.combine(seed, 0))
    is_mirror = scatter_rand < metallicity
    is_transmissive = ~is_mirror & (scatter_rand < metallicity + (1.0 - alpha))
    is_lambertian = hit_any & ~is_mirror & ~is_transmissive

    # ---- lambertian branch (reference raytrace.rs:603-675) ----
    lam_origin = hit_point + normal * _EPS15
    if nee_type == 1:
        do_nee = is_lambertian
    elif nee_type == 2:
        do_nee = is_lambertian & (bounce == 0)
    else:
        do_nee = torch.zeros_like(is_lambertian)

    picked = None
    if nee_type == 0:
        # no light sampling; the draws below keep their indices, so images
        # match across modes
        bvh = BvhSample(success=do_nee,
                        prim=torch.zeros(n, dtype=torch.int64, device=dev),
                        probability=one, importance=zero)
    else:
        bvh, picked = pick(lam_origin, normal, rng.combine(seed, 2), do_nee)
    mis_weight = torch.where(bvh.success & (bvh.importance > 0.0),
                             NEE_MIS_WEIGHT, 0.0).to(_F32)
    pick_light = rng.finalizef(rng.combine(seed, 3)) < mis_weight
    u4 = rng.finalizef(rng.combine(seed, 4))
    u5 = rng.finalizef(rng.combine(seed, 5))

    lam_dir = cosine_hemisphere(u4, u5, normal, tangent, bitangent)
    if nee_type != 0:
        # light point p0 + u*e1 + v*e2, with the triangle fold
        # (raytrace.rs:317-323)
        lp0, le1, le2 = (a[bvh.prim] for a in (lights.p0, lights.e1,
                                               lights.e2))
        fold = lights.is_tri[bvh.prim] & (u4 + u5 > 1.0)
        lu = torch.where(fold, 1.0 - u4, u4)
        lv = torch.where(fold, 1.0 - u5, u5)
        to_light = V3(*(lp0[:, c] + lu * le1[:, c] + lv * le2[:, c] - lo
                        for c, lo in enumerate(lam_origin)))
        light_dir = to_light / vec3.norm(to_light).clamp_min(1e-20)
        lam_dir = vec3.where(pick_light, light_dir, lam_dir)
    lam_bsdf_pdf = vec3.dot(lam_dir, normal) * _INV_PI

    # ---- merge branches ----
    new_origin = vec3.where(is_lambertian, lam_origin, hit_point)
    new_direction = vec3.where(
        is_mirror, reflect(direction, normal),
        vec3.where(is_transmissive, direction, lam_dir))
    # colors stay in the color dtype: a select between it and float32
    # would widen them.  (The float32 1/pi rounds every normal bfloat16
    # reflectivity as the reference's bfloat16 1/pi does.)
    zero_c, one_c = zero.to(cdt), one.to(cdt)
    out_reflect = vec3.where(
        is_mirror, reflectivity,
        vec3.where(is_transmissive, V3(one_c, one_c, one_c),
                   reflectivity * _INV_PI))
    out_bsdf_pdf = torch.where(is_lambertian, lam_bsdf_pdf, one)
    out_mis = torch.where(is_lambertian, mis_weight, zero)
    out_emis = emissivity

    # ---- miss: directional sky (reference raytrace.rs:528-538) ----
    miss = alive & ~hit_any
    sky = torch.where(direction.y > SKY_COS_CUTOFF, SKY_EMISSION, 0.0).to(cdt)
    zero3 = V3(zero, zero, zero)
    zero3c = V3(zero_c, zero_c, zero_c)
    new_origin = vec3.where(miss, origin + direction * MISS_DISTANCE,
                            new_origin)
    new_direction = vec3.where(miss, zero3, new_direction)
    normal = vec3.where(miss, zero3, normal)
    out_emis = vec3.where(miss, V3(sky, sky, sky), out_emis)
    out_reflect = vec3.where(miss, zero3c, out_reflect)
    out_mis = torch.where(miss, zero, out_mis)
    out_bsdf_pdf = torch.where(miss, one, out_bsdf_pdf)

    # ---- terminal passthrough (reference raytrace.rs:484-494) ----
    dead = ~alive
    new_origin = vec3.where(dead, origin, new_origin)
    new_direction = vec3.where(dead, zero3, new_direction)
    normal = vec3.where(dead, zero3, normal)
    out_emis = vec3.where(dead, zero3c, out_emis)
    out_reflect = vec3.where(dead, zero3c, out_reflect)
    out_mis = torch.where(dead, zero, out_mis)
    out_bsdf_pdf = torch.where(dead, one, out_bsdf_pdf)
    return (new_origin, new_direction, normal, out_emis, out_reflect,
            out_mis, out_bsdf_pdf, picked)


def throughput_factor(new_direction: V3, reflectivity: V3, mis, bsdf_pdf,
                      nee_pdf) -> V3:
    """refl * (p/q) * valid: the one-sample-MIS reweighting of the
    reference's backward recurrence (outgoing_radiance.rs:77-87), folded
    forward into the throughput.  p/q is taken in float32 and rounded
    once to the reflectivity's (color) dtype."""
    valid = vec3.any_nonzero(new_direction)
    q = nee_pdf * mis + (1.0 - mis) * bsdf_pdf
    # a zero-probability sample contributes nothing beyond its emission
    w = torch.where(q > 0.0, bsdf_pdf / q.clamp_min(1e-35),
                    torch.zeros_like(q))
    return reflectivity * (w * valid.to(_F32)).to(reflectivity.x.dtype)

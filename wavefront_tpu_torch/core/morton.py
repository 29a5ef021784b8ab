"""Morton (Z-order) codes: the 2-D interleave and its inverse (the
ray-layout debug view) and the 3-D key of the bounce sort without the
tracer's presort.

The reference carries 2-D/3-D bit-interleaving helpers in its trace
kernel (raytrace.rs:402-457); the renderer's `debug_view` paints each
bounce-1 ray slot with its deinterleaved 2-D position
(raytrace.rs:496-523), and with `trace_presort=False` the bounce sort of
`sort_type` 1 keys on `morton_key_3d_soa` of the ray origins, as the JAX
package's non-hoisted sort does.  Values are unsigned 32-bit words held in
int64 tensors.
"""

from __future__ import annotations

import torch


def spread_bits_2(x) -> torch.Tensor:
    """Spread the low 16 bits of x, inserting one zero between bits."""
    x = torch.as_tensor(x).to(torch.int64) & 0x0000FFFF
    x = (x | (x << 8)) & 0x00FF00FF
    x = (x | (x << 4)) & 0x0F0F0F0F
    x = (x | (x << 2)) & 0x33333333
    x = (x | (x << 1)) & 0x55555555
    return x


def interleave_bits_2(i, j) -> torch.Tensor:
    """32-bit 2-D morton code from two 16-bit ints (reference
    raytrace.rs:406-412: j occupies the odd bits)."""
    return spread_bits_2(i) | (spread_bits_2(j) << 1)


def deinterleave_bits_2(z: torch.Tensor):
    """Inverse of the 2-D morton interleave (reference raytrace.rs:414-421):
    (even bits, odd bits) of the unsigned 32-bit values in `z`, as int64."""
    z = z.to(torch.int64) & 0xFFFFFFFF

    def compact(x):
        x = x & 0x55555555
        x = (x | (x >> 1)) & 0x33333333
        x = (x | (x >> 2)) & 0x0F0F0F0F
        x = (x | (x >> 4)) & 0x00FF00FF
        x = (x | (x >> 8)) & 0x0000FFFF
        return x

    return compact(z), compact(z >> 1)


def spread_bits_3(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of x, inserting two zeros between bits
    (reference raytrace.rs:426-433)."""
    x = x.to(torch.int64) & 0x000003FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def interleave_bits_3(i, j, k) -> torch.Tensor:
    """30-bit 3-D morton code from three 10-bit ints: the intended
    interleave, not the reference's (raytrace.rs:435-440 drops its
    spreads), as in the JAX package."""
    return (spread_bits_3(i) << 2) | (spread_bits_3(j) << 1) \
        | spread_bits_3(k)


def discretize_position(p: torch.Tensor, lo: float = -50.0,
                        hi: float = 50.0) -> torch.Tensor:
    """World positions (per-axis domain [lo, hi], reference
    raytrace.rs:447-457) to 10-bit lattice coordinates, in float32 as the
    JAX package rounds them."""
    mapped = ((p.to(torch.float32) - lo) / (hi - lo)).clamp(0.0, 1.0)
    return (mapped * 1023.0).to(torch.int64)


def morton_key_3d(p, lo: float = -50.0, hi: float = 50.0) -> torch.Tensor:
    """30-bit morton key of world positions p (..., 3); the inter-bounce
    ray sort key the reference intended (raytrace.rs:692)."""
    ijk = discretize_position(torch.as_tensor(p), lo, hi)
    return interleave_bits_3(ijk[..., 0], ijk[..., 1], ijk[..., 2])


def morton_key_3d_soa(x, y, z, lo: float = -50.0,
                      hi: float = 50.0) -> torch.Tensor:
    """30-bit morton key of the positions (x, y, z), component tensors:
    the inter-bounce ray sort key the reference intended
    (raytrace.rs:692)."""
    return interleave_bits_3(discretize_position(x, lo, hi),
                             discretize_position(y, lo, hi),
                             discretize_position(z, lo, hi))

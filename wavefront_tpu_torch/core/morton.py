"""Morton (Z-order) bit compaction for the ray-layout debug view.

The reference carries 2-D bit-interleaving helpers in its trace kernel
(raytrace.rs:402-457); the renderer's `debug_view` paints each bounce-1
ray slot with its deinterleaved 2-D position (raytrace.rs:496-523).  The
port's bounce sort uses the coherence key, so only the inverse is needed.
"""

from __future__ import annotations

import torch


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

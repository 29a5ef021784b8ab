"""Stateless murmur3 RNG on tensors (reference raytrace.rs:117-161).

Every random number of a frame is a pure function of (invocation seed,
pixel id, draw index), so no `torch.Generator` is involved.

Hashes are carried as int64 tensors holding the unsigned 32-bit value
(0 <= h < 2**32): PyTorch on the CPU has no right shift for uint32.  The
32x32-bit products are split so that no int64 intermediate overflows, and
every result is masked back to 32 bits.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def as_u32(x, device=None) -> torch.Tensor:
    """A tensor or Python int as an int64 tensor of unsigned 32-bit values."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & MASK32
    return torch.tensor(int(x) & MASK32, dtype=torch.int64, device=device)


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2**32 for 0 <= h, c < 2**32, exact in int64."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def combine(h, k) -> torch.Tensor:
    """One murmur3 block-mix round (reference raytrace.rs:134-142)."""
    k = as_u32(k)
    h = as_u32(h, device=k.device)
    h = h ^ _mul32(k, 0x1B873593)
    h = ((h << 13) & MASK32) | (h >> 19)
    return (_mul32(h, 5) + 0xE6546B64) & MASK32


def finalize(h) -> torch.Tensor:
    """Murmur3 finalizer (reference raytrace.rs:146-153)."""
    h = as_u32(h)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def float_construct(m) -> torch.Tensor:
    """32 random bits -> float32 in [0, 1) by mantissa stuffing
    (reference raytrace.rs:120-129): (m & 0x7FFFFF) | 0x3F800000 read as
    a float32, minus 1."""
    bits = ((as_u32(m) & 0x007FFFFF) | 0x3F800000).to(torch.int32)
    return bits.view(torch.float32) - 1.0


def finalizef(h) -> torch.Tensor:
    """finalize + float_construct (reference raytrace.rs:159-161)."""
    return float_construct(finalize(h))

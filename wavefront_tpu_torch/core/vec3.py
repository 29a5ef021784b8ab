"""Struct-of-arrays 3-vectors: per-ray vector state as three (N,) tensors.

`dot` and `norm` sum in component order ((x+y)+z), the order of the
reference package, so both packages round alike.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class V3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @staticmethod
    def from_array(a: torch.Tensor) -> "V3":
        """(N, 3) -> V3 of (N,) contiguous components."""
        return V3(a[..., 0].contiguous(), a[..., 1].contiguous(),
                  a[..., 2].contiguous())

    @staticmethod
    def full_like(ref: "V3", value) -> "V3":
        """A V3 of `value` with each of ref's components' shape, dtype and
        device."""
        return V3(torch.full_like(ref.x, value), torch.full_like(ref.y, value),
                  torch.full_like(ref.z, value))

    def stack(self) -> torch.Tensor:
        """V3 -> (N, 3)."""
        return torch.stack([self.x, self.y, self.z], dim=-1)

    def map(self, fn) -> "V3":
        """Apply `fn` to each component (slicing, gathers, device moves)."""
        return V3(fn(self.x), fn(self.y), fn(self.z))

    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)


def dot(a: V3, b: V3) -> torch.Tensor:
    return (a.x * b.x + a.y * b.y) + a.z * b.z


def cross(a: V3, b: V3) -> V3:
    return V3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def norm(a: V3) -> torch.Tensor:
    return torch.sqrt(dot(a, a))


def where(mask: torch.Tensor, a: V3, b: V3) -> V3:
    """Per-ray select with an (N,) mask."""
    return V3(
        torch.where(mask, a.x, b.x),
        torch.where(mask, a.y, b.y),
        torch.where(mask, a.z, b.z),
    )


def any_nonzero(a: V3) -> torch.Tensor:
    return (a.x != 0.0) | (a.y != 0.0) | (a.z != 0.0)

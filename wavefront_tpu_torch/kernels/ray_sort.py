"""The bounce sort's key and permute: the CUDA kernels `csrc/ray_sort.cu`
(`ray_key_kernel`, `ray_permute_kernel`) and their plain PyTorch versions
`ray_key_plain` and `ray_permute_plain`.

They replace no TPU kernel: the JAX package builds its bounce-sort key
(`wavefront_tpu/kernels/window_trace.py::_coherence_key`) and permutes
its rays (`wavefront_tpu/render/renderer.py`) with plain jnp ops, which
XLA fuses.  Run eagerly, the key is 57 elementwise ops a bounce on int64
and the permute 13 gathers that each read the permutation again; the
renderer's bounce sort (`render/renderer.py::coherence_sort`) is now one
key launch, `torch.sort` and one permute launch.

`ray_key`: the tracer's coherence key (`window_trace.coherence_key`) of
grid-local origins, shifted right by 5, as int32.  The 64-bit key's low
five bits are always 0, so the value lies below 2^27: the dead flag at
bit 26, then the 32^3 window, the direction class and the fine cell, in
the 64-bit key's order.  A stable sort of it gives the 64-bit key's
permutation, and cub's radix sort walks 32 bits in place of 64.

`ray_permute`: `[c[perm] for c in columns]` in one launch, for up to 16
columns of 2 or 4 bytes (float32, int32, bfloat16); any key's
permutation (int64 indices, as `torch.sort` returns them).  One thread
an output slot reads the permutation once and moves every column.

Bound on the card: bytes.  The key reads 24 and writes 4 bytes a ray (28
B); the permute reads the permutation once and each column at its
permuted slot, and writes each column in order (about 112 B a ray for the
frame's 13 columns).  See the source note in the .cu file and PERF.md.

CPU tensors take the plain versions; CUDA tensors launch the kernel or
raise.  Each wrapper's `launches` counts its kernel's launches (an empty
input launches nothing).
"""

from __future__ import annotations

import ctypes
import math

import torch

from wavefront_tpu_torch.core.vec3 import V3
from wavefront_tpu_torch.kernels import _build
from wavefront_tpu_torch.kernels.window_trace import W, coherence_key

# the 64-bit coherence key's low bits that are always 0
KEY_SHIFT = 5
MAX_COLUMNS = 16
# what the permute moves: each column's dtype, by its width in bytes
COLUMN_DTYPES = {torch.float32: 4, torch.int32: 4, torch.bfloat16: 2}


def ray_key_plain(o: V3, d: V3, grid_origin, grid_shape):
    """Plain PyTorch version of the key kernel (same arguments as
    `ray_key`)."""
    go = grid_origin
    key = coherence_key(o.x - float(go[0]), o.y - float(go[1]),
                        o.z - float(go[2]), d.x, d.y, d.z, *grid_shape)
    return (key >> KEY_SHIFT).to(torch.int32)


_KEY = _build.Launcher("ray_sort", "rs_key", "ppppppfffiiipi", "ray_key")


def ray_key(o: V3, d: V3, grid_origin, grid_shape):
    """(N,) int32 bounce-sort key of the rays (module note).

    o, d: V3 of (N,) float32 world-space origins and directions (a zero
    direction is a dead ray, which sorts last); grid_origin: the grid's
    integer world origin; grid_shape: (gx, gy, gz).  The six tensors must
    be contiguous (N,) float32 on one device, or it raises."""
    comps = (*o, *d)
    dev = comps[0].device
    n = comps[0].shape[0]
    for c in comps:
        if (c.device != dev or c.dtype != torch.float32 or c.dim() != 1
                or c.shape[0] != n or not c.is_contiguous()):
            raise ValueError("ray_key: origin/direction must be six "
                             "contiguous (N,) float32 tensors on one device")
    if dev.type == "cpu":
        return _build.plain("ray_key", ray_key_plain, o, d, grid_origin,
                            grid_shape)
    gx, gy, gz = grid_shape
    key = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        _KEY(dev.index, *(c.data_ptr() for c in comps),
             *(float(g) for g in grid_origin), math.ceil(gx / W),
             math.ceil(max(gy, 1) / W), math.ceil(gz / W), key.data_ptr(), n)
        ray_key.launches += 1
    return key


ray_key.launches = 0


def ray_permute_plain(perm, columns):
    """Plain PyTorch version of the permute kernel: one gather a column."""
    return [c[perm] for c in columns]


_PERMUTE = _build.Launcher("ray_sort", "rs_permute", "ppiui", "ray_permute")


def ray_permute(perm, columns):
    """[c[perm] for c in columns], as a list.

    perm: contiguous (N,) int64, a permutation of range(N); columns: 1 to
    16 contiguous (N,) tensors of the dtypes in COLUMN_DTYPES, on perm's
    device.  Anything else raises, on the CPU too."""
    columns = list(columns)
    dev = perm.device
    n = perm.shape[0]
    if perm.dtype != torch.int64 or perm.dim() != 1 \
            or not perm.is_contiguous():
        raise ValueError("ray_permute: perm must be a contiguous (N,) int64 "
                         "tensor")
    if not 1 <= len(columns) <= MAX_COLUMNS:
        raise ValueError(f"ray_permute: {len(columns)} columns (1 to "
                         f"{MAX_COLUMNS})")
    wide = 0
    for k, c in enumerate(columns):
        width = COLUMN_DTYPES.get(c.dtype)
        if (width is None or c.device != dev or c.dim() != 1
                or c.shape[0] != n or not c.is_contiguous()):
            raise ValueError(
                "ray_permute: each column must be a contiguous (N,) tensor "
                f"of {', '.join(map(str, COLUMN_DTYPES))} on perm's device "
                f"(column {k}: {c.dtype}, {tuple(c.shape)}, {c.device})")
        wide |= (width == 4) << k
    if dev.type == "cpu":
        return _build.plain("ray_permute", ray_permute_plain, perm, columns)
    out = [torch.empty(n, dtype=c.dtype, device=dev) for c in columns]
    if n:
        ptrs = (ctypes.c_void_p * (2 * len(columns)))(
            *(c.data_ptr() for c in columns), *(c.data_ptr() for c in out))
        _PERMUTE(dev.index, perm.data_ptr(), ptrs, len(columns), wide, n)
        ray_permute.launches += 1
        _build.check_outputs("ray_permute", out)
    return out


ray_permute.launches = 0

"""The atlas texel fetch: the CUDA kernel `csrc/texel.cu` and its plain
PyTorch version `texel_plain`.

Replaces the TPU kernel `wavefront_tpu/kernels/texel.py::_kernel` (called
by `texel_fetch()`): per ray, the nearest/clamp read
`atlas_packed[clip(tex), clip(int(v*size)), clip(int(u*size)), channels]`,
returned channel-major (nch, N) so the shade reads each channel as a row.
The non-fused shade (`render.renderer`) calls it once per bounce.

Bound on the card: bytes — 12 per ray in (tex, u, v) and 4 per channel
out; the atlas stays in L2 (see the source note in the .cu file and
PERF.md).

Non-finite and huge coordinates: the conversion to a texel index
saturates, so NaN and anything below 0 read texel 0 and anything at or
above `size` (+inf included) reads texel size-1; `tex` clamps into
[0, T-1].  The kernel and `texel_plain` agree on every lane, finite or
not, and never read out of bounds.  (Miss and dead lanes reach the fetch
with such values; the shade masks their texels.)
"""

from __future__ import annotations

import ctypes

import torch

from wavefront_tpu_torch.kernels import _build

MAX_CHANNELS = 12


def texel_index(atlas_packed, tex, u, v):
    """(tex, tj, ti) int64 indices of each ray's texel: nearest sampling,
    clamp to edge, uv (0, 0) at the first texel row; the saturating
    conversion of the module note."""
    n_tex, size = atlas_packed.shape[0], atlas_packed.shape[1]

    def cell(x):
        x = torch.nan_to_num(x * float(size), nan=0.0)
        return x.clamp(0.0, float(size - 1)).to(torch.int64)

    return tex.to(torch.int64).clamp(0, n_tex - 1), cell(v), cell(u)


def _channel_list(atlas_packed, channels):
    row = atlas_packed.shape[-1]
    chans = tuple(range(row)) if channels is None else tuple(
        int(c) for c in channels)
    if not 1 <= len(chans) <= MAX_CHANNELS or any(
            c < 0 or c >= row for c in chans):
        raise ValueError(f"texel_fetch: channels {chans} do not index a "
                         f"{row}-channel texel (at most {MAX_CHANNELS})")
    return chans


def texel_plain(atlas_packed, tex, u, v, channels=None):
    """Plain PyTorch version of the texel kernel (same arguments as
    texel_fetch): index arithmetic and one advanced-index read."""
    chans = _channel_list(atlas_packed, channels)
    t, tj, ti = texel_index(atlas_packed, tex, u, v)
    return atlas_packed[t, tj, ti][:, list(chans)].t().contiguous()


_LAUNCH = _build.Launcher("texel", "texel_launch", "piiippppipi",
                         "texel_fetch")


def texel_fetch(atlas_packed, tex, u, v, channels=None):
    """(N,) tex/u/v -> (nch, N) float32 texels, channel-major.

    atlas_packed: (T, size, size, C) float32, the scene's packed atlas;
    tex: (N,) int32 texture slots; u, v: (N,) float32; channels: up to 12
    channel indices (output row k is channel channels[k]; any order,
    repeats allowed), all C channels when None.  CPU tensors take
    `texel_plain`; CUDA tensors launch the kernel or raise.  What a
    non-finite u or v yields is in the module note."""
    chans = _channel_list(atlas_packed, channels)
    if tex.device.type == "cpu":
        return texel_plain(atlas_packed, tex, u, v, chans)
    dev = tex.device
    n = tex.shape[0]
    for x, dt in ((tex, torch.int32), (u, torch.float32), (v, torch.float32)):
        if (x.device != dev or x.dtype != dt or x.dim() != 1
                or x.shape[0] != n or not x.is_contiguous()):
            raise ValueError("texel_fetch: tex (int32), u and v (float32) "
                             "must be contiguous (N,) tensors on one device")
    a = atlas_packed
    if (a.device != dev or a.dtype != torch.float32 or a.dim() != 4
            or a.shape[1] != a.shape[2] or not a.is_contiguous()):
        raise ValueError("texel_fetch: atlas must be a contiguous "
                         "(T, size, size, C) float32 tensor on the rays' "
                         "device")
    out = torch.empty((len(chans), n), dtype=torch.float32, device=dev)
    _LAUNCH(dev.index, a.data_ptr(), a.shape[0], a.shape[1], a.shape[3],
            tex.data_ptr(), u.data_ptr(), v.data_ptr(), out.data_ptr(), n,
            (ctypes.c_int * len(chans))(*chans), len(chans))
    texel_fetch.launches += 1
    return out


texel_fetch.launches = 0

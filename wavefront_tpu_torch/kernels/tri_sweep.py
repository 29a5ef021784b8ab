"""The entity triangle sweep: the CUDA kernel `csrc/tri_sweep.cu`
(`tri_sweep_kernel`, S5), one thread a ray, every active triangle of the
pool in one launch.

It replaces no TPU kernel: the JAX package's sweep
(`wavefront_tpu/render/intersect.py::triangle_sweep`) is jnp code.  Its
plain version is `render/intersect.py::triangle_sweep_plain`, which
`triangle_sweep` runs for CPU tensors; run eagerly on the card it gathers
the active slots with a host sync and launches ~40 elementwise kernels
for each chunk of 2^18 rays.

Per ray (module note of the .cu file): the active triangles, staged once
a block in slot order from the mask on the device, are tested with the
plain version's float32 operations, and a strictly nearer hit replaces
the kept one, so hit, t and the slot are its outputs bit for bit (and
the barycentrics on every hit ray).  The sweep takes no host sync.

`entity_stream` is the fused shade's form of the same launch
(`tri_sweep_kernel<true>`): it merges the hits into the tracer's and
writes K2's 12-word entity stream in place of the sweep's outputs, as
`render/renderer.py::entity_attrs_plain` computes them from the plain
sweep (the merged t and the flag word on every ray, the other 11 words
on the rays an entity wins, the only ones K2 reads).

Bound on the card: operations, ~64 a ray-triangle test; bytes are 24 in
and 21 out a ray (32 in and 52 out in the stream form).  See PERF.md.

`tri_sweep.launches` counts the kernel's launches in either form (an
empty input launches nothing).
"""

from __future__ import annotations

import ctypes

import torch

from wavefront_tpu_torch.kernels import _build

_SWEEP = _build.Launcher("tri_sweep", "ts_sweep", "p" * 8 + "iff" + "p" * 6
                         + "i", "tri_sweep")
_STREAM = _build.Launcher("tri_sweep", "ts_stream", "p" * 8 + "iff" + "p" * 4
                          + "i" + "p" * 4 + "i", "entity_stream")


def _check(what: str, t, dtype, shape, dev) -> None:
    if (t.dtype != dtype or tuple(t.shape) != shape or t.device != dev
            or not t.is_contiguous()):
        raise ValueError(
            f"tri_sweep: {what} must be a contiguous {dtype} tensor of "
            f"shape {shape} on {dev} (got {t.dtype}, {tuple(t.shape)}, "
            f"{t.device})")


def _check_pool(tri_verts, tri_active, origin, direction, counts):
    """The pool's and the rays' checks of both forms; returns (device,
    pool slots, rays)."""
    dev = tri_active.device
    if dev.type != "cuda":
        raise ValueError("tri_sweep: CUDA tensors only; the plain version "
                         "is render.intersect.triangle_sweep_plain")
    cap = tri_active.shape[0]
    _check("tri_verts", tri_verts, torch.float32, (cap, 3, 3), dev)
    _check("tri_active", tri_active, torch.bool, (cap,), dev)
    n = origin.x.shape[0]
    for k, c in enumerate((*origin, *direction)):
        _check(f"ray column {k}", c, torch.float32, (n,), dev)
    if counts is not None and (counts.dtype != torch.int64
                               or counts.device != dev
                               or counts.numel() < 1
                               or not counts.is_contiguous()):
        raise ValueError("tri_sweep: counts must be a contiguous int64 "
                         f"tensor on {dev} with at least one element")
    return dev, cap, n


def tri_sweep(tri_verts, tri_active, origin, direction, t_min: float,
              t_max: float, counts=None):
    """(hit (N,) bool, t (N,) float32, tri (N,) int64, bary_u, bary_v (N,)
    float32): the closest active triangle of the pool each ray crosses
    with t_min <= t <= t_max (`triangle_sweep`'s result; a miss has t
    3e38, slot 0 and barycentrics 0).  counts: an int64 tensor whose first
    element the number of active triangles is added to, or None.

    tri_verts: contiguous (T, 3, 3) float32; tri_active: contiguous (T,)
    bool; origin, direction: V3 of contiguous (N,) float32; all on one
    CUDA device, or it raises (CPU tensors take
    `render/intersect.py::triangle_sweep_plain`)."""
    dev, cap, n = _check_pool(tri_verts, tri_active, origin, direction,
                              counts)
    rays = (*origin, *direction)
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    tri = torch.empty(n, dtype=torch.int64, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    if n:
        _SWEEP(dev.index, *(c.data_ptr() for c in rays),
               tri_verts.data_ptr(), tri_active.data_ptr(), cap,
               float(t_min), float(t_max), hit.data_ptr(), t.data_ptr(),
               tri.data_ptr(), u.data_ptr(), v.data_ptr(),
               None if counts is None else counts.data_ptr(), n)
        tri_sweep.launches += 1
        _build.check_outputs("tri_sweep", (t, u, v))
    return hit, t, tri, u, v


tri_sweep.launches = 0


def entity_stream(tri_verts, tri_active, tri_uv, tri_tex, n_tex: int,
                  origin, direction, pa, t, t_min: float, t_max: float,
                  counts=None):
    """(merged t (N,) float32, the 12-tensor entity stream of
    `kernels.shade.shade_pass`): the sweep of `tri_sweep` merged into the
    tracer's hits (pa (N,) int32, t (N,) float32) and the winning
    triangle's shading frame, uv and texture (clamped to the atlas's
    `n_tex` textures), as `render/renderer.py::entity_attrs_plain`
    returns them; the 11 float words are 0 on the rays no entity wins.

    tri_uv: contiguous (T, 3, 2) float32; tri_tex: contiguous (T,) int32;
    the rest as `tri_sweep`'s; all on one CUDA device, or it raises (CPU
    tensors take `entity_attrs_plain`)."""
    dev, cap, n = _check_pool(tri_verts, tri_active, origin, direction,
                              counts)
    _check("tri_uv", tri_uv, torch.float32, (cap, 3, 2), dev)
    _check("tri_tex", tri_tex, torch.int32, (cap,), dev)
    _check("pa", pa, torch.int32, (n,), dev)
    _check("t", t, torch.float32, (n,), dev)
    if n_tex < 1:
        raise ValueError(f"entity_stream: n_tex {n_tex} must be positive")
    # the merged t and the 11 float words, each a contiguous row
    t_out, *words = torch.empty((12, n), dtype=torch.float32, device=dev)
    flag = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        ptrs = (ctypes.c_void_p * 11)(*(w.data_ptr() for w in words))
        _STREAM(dev.index, *(c.data_ptr() for c in (*origin, *direction)),
                tri_verts.data_ptr(), tri_active.data_ptr(), cap,
                float(t_min), float(t_max), pa.data_ptr(), t.data_ptr(),
                tri_uv.data_ptr(), tri_tex.data_ptr(), int(n_tex),
                t_out.data_ptr(), ptrs, flag.data_ptr(),
                None if counts is None else counts.data_ptr(), n)
        tri_sweep.launches += 1
        _build.check_outputs("entity_stream", (t_out, *words))
    return t_out, (*words, flag)

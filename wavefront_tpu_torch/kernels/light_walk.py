"""The forward light-BVH walk of a sparse light set: the CUDA kernel
`csrc/light_walk.cu` (`light_walk_kernel`, S4), one thread a ray, every
level of its stochastic descent in one launch.

It replaces no TPU kernel: the JAX package's walk
(`wavefront_tpu/render/wavefront.py::traverse_light_bvh`) is jnp code.
Its plain version is `render/wavefront.py::light_walk_plain`, which
`traverse_light_bvh` runs for CPU tensors; run eagerly on the card it
launches ~190 elementwise kernels a level and takes a host sync for each
level's test for a running walk.

Per ray (module note of the .cu file): the levels run in registers, the
node table read through the read-only cache, with the plain version's
float32 operations and murmur3 draws, so the outputs are its outputs bit
for bit.  The walk takes no host sync.

Bound on the card: operations, two box importances, the branch
probability and the draw a level; bytes are ~50 a ray.  See PERF.md.

`launches` counts the kernel's launches (an empty input launches
nothing).
"""

from __future__ import annotations

import torch

from wavefront_tpu_torch.kernels import _build

_WALK = _build.Launcher("light_walk", "lw_walk", "p" * 13 + "ii" + "p" * 4
                        + "i", "light_walk")


def _check(what: str, t, dtype, shape, dev) -> None:
    if (t.dtype != dtype or tuple(t.shape) != shape or t.device != dev
            or not t.is_contiguous()):
        raise ValueError(
            f"light_walk: {what} must be a contiguous {dtype} tensor of "
            f"shape {shape} on {dev} (got {t.dtype}, {tuple(t.shape)}, "
            f"{t.device})")


def light_walk(lights, point, normal, seed, active, max_depth: int):
    """(success (N,) bool, prim (N,) int64, probability (N,) float32,
    importance (N,) float32) of the rays' stochastic light-BVH descent
    (`traverse_light_bvh`'s result), at most `max_depth` levels.

    lights: a sparse `LightArrays`; point, normal: V3 of contiguous (N,)
    float32; seed: contiguous (N,) int64 of uint32 values; active:
    contiguous (N,) bool; all on one CUDA device, or it raises (CPU
    tensors take `render/wavefront.py::light_walk_plain`)."""
    dev = active.device
    if dev.type != "cuda":
        raise ValueError("light_walk: CUDA tensors only; the plain version "
                         "is render.wavefront.light_walk_plain")
    if max_depth < 0:
        raise ValueError(f"light_walk: max_depth {max_depth} must not be "
                         "negative")
    n = active.shape[0]
    rays = (*point, *normal)
    for k, c in enumerate(rays):
        _check(f"ray column {k}", c, torch.float32, (n,), dev)
    _check("seed", seed, torch.int64, (n,), dev)
    _check("active", active, torch.bool, (n,), dev)
    m = lights.node_min.shape[0]
    if m < 1:
        raise ValueError("light_walk: the node table has no rows")
    for name, dtype, shape in (
            ("node_left", torch.int64, (m,)),
            ("node_right", torch.int64, (m,)),
            ("node_min", torch.float32, (m, 3)),
            ("node_max", torch.float32, (m, 3)),
            ("node_power", torch.float32, (m,))):
        _check(f"lights.{name}", getattr(lights, name), dtype, shape, dev)
    success = torch.empty(n, dtype=torch.bool, device=dev)
    prim = torch.empty(n, dtype=torch.int64, device=dev)
    prob = torch.empty(n, dtype=torch.float32, device=dev)
    imp = torch.empty(n, dtype=torch.float32, device=dev)
    if n:
        _WALK(dev.index, *(c.data_ptr() for c in rays), seed.data_ptr(),
              active.data_ptr(), lights.node_left.data_ptr(),
              lights.node_right.data_ptr(), lights.node_min.data_ptr(),
              lights.node_max.data_ptr(), lights.node_power.data_ptr(), m,
              max_depth, success.data_ptr(), prim.data_ptr(),
              prob.data_ptr(), imp.data_ptr(), n)
        light_walk.launches += 1
        _build.check_outputs("light_walk", (prob, imp))
    return success, prim, prob, imp


light_walk.launches = 0

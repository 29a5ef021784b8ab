"""The sparse NEE pdf sweep: the CUDA kernel `csrc/nee_sweep.cu`
(`nee_sweep_kernel`), one thread a ray, with its crossings, their reverse
light-BVH walks and the slot sum in one launch.

It replaces no TPU kernel: the JAX package's sparse sweep
(`wavefront_tpu/render/wavefront.py::nee_pdf_sweep`) is jnp code.  Its
plain version is `render/wavefront.py::nee_sweep_plain`, which
`nee_pdf_sweep` runs for CPU tensors; run eagerly on the card it builds
(rays x 64) temporaries a prim tile and takes a host sync for each tile's
crossings and each level of its reverse walk.

Per ray (module note of the .cu file): the prims are tested in index
order with the plain version's float32 operations, the first `max_hits`
crossings are the ray's slots and each one's walk runs when it is found,
and the slots are summed in slot order.  The crossings and the rays with
more than `max_hits` of them are added to a (2,) int64 device tensor, so
the sweep takes no host sync: the renderer reads it with the frame's
audit.

Bound on the card: operations, ~30 a ray-prim test and two box
importances a level of each kept crossing's walk; bytes are ~44 a ray.
See PERF.md.

`launches` counts the kernel's launches (an empty input launches
nothing).
"""

from __future__ import annotations

import torch

from wavefront_tpu_torch.kernels import _build

_SWEEP = _build.Launcher("nee_sweep", "ns_sweep",
                         "p" * 17 + "i" + "p" * 6 + "iippi", "nee_sweep")


def _check(what: str, t, dtype, shape, dev) -> None:
    if (t.dtype != dtype or tuple(t.shape) != shape or t.device != dev
            or not t.is_contiguous()):
        raise ValueError(
            f"nee_sweep: {what} must be a contiguous {dtype} tensor of "
            f"shape {shape} on {dev} (got {t.dtype}, {tuple(t.shape)}, "
            f"{t.device})")


def nee_sweep(lights, point, normal, direction, mis_weight, max_depth: int,
              max_hits: int, counts):
    """(N,) float32 sparse NEE pdf of the rays (`nee_pdf_sweep`'s sparse
    path), adding the light-prim crossings found to counts[0] and the
    rays with more than `max_hits` of them to counts[1].

    lights: a sparse `LightArrays`; point, normal, direction: V3 of
    contiguous (N,) float32; mis_weight: contiguous (N,) float32; counts:
    a (2,) int64 tensor; all on one CUDA device, or it raises (CPU tensors
    take `render/wavefront.py::nee_sweep_plain`)."""
    dev = mis_weight.device
    if dev.type != "cuda":
        raise ValueError("nee_sweep: CUDA tensors only; the plain version "
                         "is render.wavefront.nee_sweep_plain")
    if max_depth < 0 or max_hits < 0:
        raise ValueError(f"nee_sweep: max_depth {max_depth} and max_hits "
                         f"{max_hits} must not be negative")
    n = mis_weight.shape[0]
    rays = (*point, *normal, *direction, mis_weight)
    for k, c in enumerate(rays):
        _check(f"ray column {k}", c, torch.float32, (n,), dev)
    cap = lights.p0.shape[0]
    m = lights.node_min.shape[0]
    if not 0 <= lights.num_prims <= cap:
        raise ValueError(f"nee_sweep: num_prims {lights.num_prims} outside "
                         f"0..{cap}")
    for name, dtype, shape in (
            ("p0", torch.float32, (cap, 3)), ("e1", torch.float32, (cap, 3)),
            ("e2", torch.float32, (cap, 3)), ("area", torch.float32, (cap,)),
            ("is_tri", torch.bool, (cap,)),
            ("leaf_node", torch.int64, (cap,)),
            ("node_left", torch.int64, (m,)),
            ("node_right", torch.int64, (m,)),
            ("node_parent", torch.int64, (m,)),
            ("node_min", torch.float32, (m, 3)),
            ("node_max", torch.float32, (m, 3)),
            ("node_power", torch.float32, (m,))):
        _check(f"lights.{name}", getattr(lights, name), dtype, shape, dev)
    _check("counts", counts, torch.int64, (2,), dev)
    pdf = torch.empty(n, dtype=torch.float32, device=dev)
    if n:
        # the prims' normals by the plain version's own op (module note
        # of the .cu file)
        nv = torch.linalg.cross(lights.e1, lights.e2)
        _SWEEP(dev.index, *(c.data_ptr() for c in rays),
               lights.p0.data_ptr(), lights.e1.data_ptr(),
               lights.e2.data_ptr(), nv.data_ptr(), lights.area.data_ptr(),
               lights.is_tri.data_ptr(), lights.leaf_node.data_ptr(),
               lights.num_prims, lights.node_left.data_ptr(),
               lights.node_right.data_ptr(), lights.node_parent.data_ptr(),
               lights.node_min.data_ptr(), lights.node_max.data_ptr(),
               lights.node_power.data_ptr(), max_depth, max_hits,
               pdf.data_ptr(), counts.data_ptr(), n)
        nee_sweep.launches += 1
        _build.check_outputs("nee_sweep", pdf)
    return pdf


nee_sweep.launches = 0

"""The texel fetch alone: the texel kernel (K3) against the gather it
replaces.

Counterpart of `tools/texel_lab.py`, on its workload: a seeded random
(42, 16, 16, 12) float32 atlas, texture slots in [0, 42) and u, v in
[0, 1), drawn in the JAX tool's order from `numpy.random.default_rng(0)`,
for each ray count of `--n` (the JAX tool's 2,073,600, and 2^16 and 2^20
beside it).  Rows, each with its ms (CUDA events over `--iters` calls on
the card, the host clock on the CPU), device ms (torch.profiler; None on
the CPU) and max |diff| against the gather's channels (0: a fetch copies
float32 values):

  gather  the renderer's indexed read, `atlas[texel_index(...)]` (the
          general shade's path without the kernel, render/renderer.py),
          12 channels row-major
  12ch    `texel_fetch`, every channel, channel-major
  8ch     `texel_fetch` of the eight channels the shade reads

The JAX tool's `--tiles` (the TPU kernel's tile) has no counterpart: the
CUDA kernel takes one ray a thread.

    python -m wavefront_tpu_torch.tools.texel_lab [--n 2073600 65536] \
        [--iters 20] [--device cuda]

Without a card it exits unless given `--device cpu`, which runs the
kernel's plain version.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from wavefront_tpu_torch.kernels.texel import texel_fetch, texel_index
from wavefront_tpu_torch.render.shading import CHANNELS
from wavefront_tpu_torch.tools import _sweep
from wavefront_tpu_torch.tools._timing import emit, time_ms

N_DEFAULT = (2073600, 1 << 16, 1 << 20)
SLOTS, SIZE, NCH = 42, 16, 12


def workload(n: int, dev):
    """(atlas, tex, u, v) of the JAX tool, on `dev`."""
    rng = np.random.default_rng(0)
    atlas = rng.random((SLOTS, SIZE, SIZE, NCH), np.float32)
    tex = rng.integers(0, SLOTS, n, dtype=np.int32)
    u = rng.random(n, dtype=np.float32)
    v = rng.random(n, dtype=np.float32)
    return tuple(torch.as_tensor(x, device=dev) for x in (atlas, tex, u, v))


def lab(n_list=N_DEFAULT, iters: int = 20, dev="cuda") -> list:
    dev = torch.device(dev)
    on_card = dev.type == "cuda"
    out = []
    for n in n_list:
        atlas, tex, u, v = workload(int(n), dev)

        def gather():
            return atlas[texel_index(atlas, tex, u, v)]

        want = gather()
        for name, fn, chans in (
            ("gather", gather, None),
            ("12ch", lambda: texel_fetch(atlas, tex, u, v), range(NCH)),
            ("8ch", lambda: texel_fetch(atlas, tex, u, v,
                                        channels=CHANNELS), CHANNELS),
        ):
            got = fn()
            err = 0.0 if chans is None else float(
                (got - want[:, list(chans)].t()).abs().max())
            kernel = "" if chans is None else "texel_kernel"
            out.append({
                "row": name, "n": int(n),
                "channels": NCH if chans is None else len(chans),
                "ms": time_ms(fn, iters, dev),
                "device_ms": _sweep.kernel_device_ms(fn, kernel, iters)
                if on_card else None,
                "max_abs_diff": err})
    return out


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, nargs="+", default=list(N_DEFAULT))
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--device", default="cuda",
                   help="cuda, or cpu for the kernel's plain version")
    args = p.parse_args(argv)
    dev = _sweep.device_of(args.device)
    return emit(lab(args.n, args.iters, dev), dev)


if __name__ == "__main__":
    main()

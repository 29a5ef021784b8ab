"""The comparison that decides `correct`.

After the window has closed, the device memory peak has been read and
the program's state is freed, the reference renders again the pixels of
a sample of the window's images drawn from the seed, from its own scene
(`configs/<config>.py::reference`): every frame folded into an image,
whose mean it takes.  Each sampled pixel is judged by its relative gap:

    gap = max over channels |program - reference|
          / max(max over channels |reference|, FLOOR)

A pixel is lit when either side exceeds FLOOR, and off when it is lit
and its gap exceeds TAU (or the program's value is not finite).  The
number compared, `off_share`, is the share of the lit pixels that are
off.

FLOOR is far below any lit pixel's radiance (lamp light reaches 1e-2 and
more) and TAU sits between float32 rounding (1e-7 to 1e-6 relative) and
a bfloat16 color pipeline's (1e-3 to 1e-2); the limits on the shares are
set per cell in `limits/<cell>.json` from measured readings.
"""

from __future__ import annotations

import numpy as np

FLOOR = 1e-4
TAU = 1e-3
BLOCK_RAYS = 1 << 18


def off_lit(prog: np.ndarray, ref: np.ndarray):
    """(off, lit) pixel counts of (N, 3) program and reference values."""
    prog = np.asarray(prog, np.float64)
    ref = np.asarray(ref, np.float64)
    bad = ~np.isfinite(prog).all(-1)
    prog = np.where(np.isfinite(prog), prog, 0.0)
    gap = np.abs(prog - ref).max(-1)
    mag_r = np.abs(ref).max(-1)
    lit = (np.maximum(mag_r, np.abs(prog).max(-1)) > FLOOR) | bad
    off = lit & ((gap / np.maximum(mag_r, FLOOR) > TAU) | bad)
    return int(off.sum()), int(lit.sum())


def _share(off: int, lit: int) -> float:
    # nothing lit to judge counts as nothing confirmed
    return off / lit if lit else 1.0


def _paths(ref, o, d, pix, fcs, bounces, nee_type) -> np.ndarray:
    out = []
    for a in range(0, o.shape[0], BLOCK_RAYS):
        b = a + BLOCK_RAYS
        out.append(ref.paths(o[a:b], d[a:b], pix[a:b], fcs[a:b], bounces,
                             nee_type).cpu().numpy())
    return np.concatenate(out)


def compare(cell, kept: list, seed: int, device, assets: str,
            scene=None) -> dict:
    """The cell's numbers over the kept images.  kept: dicts with the
    image's sampled pixel ids `pix` and their values `vals` (N, 3),
    `yaw`, `fc` (its first frame count) and `k` (the frames folded into
    it, frame counts fc .. fc + k - 1).  scene: the reference's (scene,
    basis) when already built."""
    cfg = cell.config
    w, h = cfg["width"], cfg["height"]
    bounces, nee = cfg["num_bounces"], cfg["nee_type"]
    ref, basis = scene or cell.build.reference(cfg, assets, device)
    off = lit = 0
    for f in kept:
        pix, k = f["pix"], f["k"]
        o, d = ref.rays(pix, w, h, basis(f["yaw"]))
        fcs = np.repeat(np.arange(f["fc"], f["fc"] + k), len(pix))
        rad = _paths(ref, o.repeat(k, 1), d.repeat(k, 1), np.tile(pix, k),
                     fcs, bounces, nee)
        o_, l_ = off_lit(f["vals"], rad.reshape(k, len(pix), 3).mean(0))
        off, lit = off + o_, lit + l_
    return {"off_share": _share(off, lit)}

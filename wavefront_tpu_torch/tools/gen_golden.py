"""Render the config-1 golden image with the port's oracle, and hold it
to the stored one.

Counterpart of `tools/gen_golden.py`: the scalar NumPy oracle
(`render/oracle.py`) renders the golden scene (`headline.config1_grid`,
`config1_pose`) at 256x256, 1 bounce, NEE 1, frame 0, in bands of rows
over a process pool (the oracle is pure per pixel; a band keeps the
whole frame's uv mapping).  The result is written under `build/` and
compared with `tests/golden/config1_256.npz`: max |diff| and the pixels
that differ.  The stored golden is the repository's record and is never
written here: an output path inside `tests/golden/` is refused.

    python -m wavefront_tpu_torch.tools.gen_golden [--out PATH] \
        [--rows Y0 Y1] [--procs N] [--device cuda]

`--rows` renders the band y0 <= y < y1 only, and compares it with those
rows of the stored image.  One JSON line, with the card's name and power
limit (the oracle runs on the host; the line says which machine it timed).
Without a card it exits unless given `--device cpu`.
"""

from __future__ import annotations

import argparse
import multiprocessing as mp
import os
import time

import numpy as np

from wavefront_tpu_torch.headline import ASSETS, REPO
from wavefront_tpu_torch.tools import _sweep
from wavefront_tpu_torch.tools._timing import emit

WIDTH = HEIGHT = 256
BOUNCES = 1
NEE_TYPE = 1
FRAME = 0
GOLDEN = os.path.join(REPO, "tests", "golden", "config1_256.npz")
DEFAULT_OUT = os.path.join(REPO, "build", "gen_golden", "config1_256.npz")


def _setup():
    """(oracle, camera basis) of the golden scene."""
    from wavefront_tpu_torch.core.config import RenderSettings
    from wavefront_tpu_torch.headline import config1_grid, config1_pose
    from wavefront_tpu_torch.render import lights as lights_mod
    from wavefront_tpu_torch.render.oracle import OracleRenderer
    from wavefront_tpu_torch.world.blocks import BlockRegistry

    registry = BlockRegistry.load(ASSETS)
    grid = config1_grid(registry)
    settings = RenderSettings(width=WIDTH, height=HEIGHT,
                              num_bounces=BOUNCES, max_trace_steps=96)
    ls = lights_mod.build_from_grid(grid, np.zeros(3), registry, 256)
    return (OracleRenderer(settings, registry, grid, (0, 0, 0), ls),
            config1_pose())


def render_rows(oracle, basis, y0: int, y1: int, nee_type: int = NEE_TYPE,
                frame: int = FRAME) -> np.ndarray:
    """Rows y0 <= y < y1 of the oracle's frame, (y1 - y0, W, 3) float32,
    its rays made from the camera's vectors in float64 (as the stored
    golden's were)."""
    vecs = (np.asarray(getattr(basis, k), np.float64)
            for k in ("eye", "front", "right", "up"))
    return oracle.render_rows(*vecs, y0, y1, frame, nee_type).astype(
        np.float32)


_worker = None


def _band(rows):
    """A pool worker's band: (y0, its rows)."""
    return rows[0], render_rows(*_worker, *rows)


def render(y0: int = 0, y1: int = HEIGHT, procs: int = 1) -> np.ndarray:
    """Rows [y0, y1) of the golden frame, in bands of 2 rows over `procs`
    forked processes (in this one when procs is 1); the lit rows sit
    together, so small bands keep the processes evenly busy.  The workers
    inherit the oracle and run NumPy alone, so a parent that holds a CUDA
    context forks them safely, and no worker imports the caller's main
    module (which a spawned one would run again)."""
    global _worker
    _worker = _setup()
    if procs <= 1:
        return render_rows(*_worker, y0, y1)
    bands = [(y, min(y + 2, y1)) for y in range(y0, y1, 2)]
    img = np.zeros((y1 - y0, WIDTH, 3), np.float32)
    with mp.get_context("fork").Pool(min(procs, len(bands))) as pool:
        for b0, band in pool.imap_unordered(_band, bands):
            img[b0 - y0:b0 - y0 + band.shape[0]] = band
    return img


def _refuse(out: str) -> None:
    golden_dir = os.path.realpath(os.path.dirname(GOLDEN))
    path = os.path.realpath(out)
    if os.path.commonpath([path, golden_dir]) == golden_dir:
        raise SystemExit(f"gen_golden: {out} lies in tests/golden/, the "
                         "repository's record; write it elsewhere")


def generate(out: str = DEFAULT_OUT, rows=(0, HEIGHT),
             procs: int = 1) -> dict:
    """Render rows [y0, y1) into `out` (an .npz with `image`, `meta` and
    `rows`) and compare them with the stored golden's."""
    _refuse(out)
    y0, y1 = (int(r) for r in rows)
    if not 0 <= y0 < y1 <= HEIGHT:
        raise ValueError(f"gen_golden: rows {rows} outside [0, {HEIGHT})")
    t0 = time.perf_counter()
    img = render(y0, y1, procs)
    seconds = time.perf_counter() - t0
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez_compressed(
        out, image=img,
        meta=np.array([WIDTH, HEIGHT, BOUNCES, NEE_TYPE, FRAME], np.int64),
        rows=np.array([y0, y1], np.int64))
    want = np.load(GOLDEN)["image"][y0:y1]
    diff = np.abs(img - want)
    tol = 1e-6 * np.maximum(1.0, np.abs(want))
    return {"tool": "gen_golden", "out": os.path.relpath(out, REPO),
            "rows": [y0, y1], "width": WIDTH, "procs": procs,
            "seconds": seconds,
            "ms_per_pixel": seconds * 1e3 / ((y1 - y0) * WIDTH),
            "max_abs_diff": float(diff.max()),
            "differing_pixels": int(diff.max(axis=-1).astype(bool).sum()),
            "within_1e-6": bool(np.all(diff <= tol)),
            "mean": float(img.mean())}


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=DEFAULT_OUT,
                   help="the .npz to write (never under tests/golden/)")
    p.add_argument("--rows", type=int, nargs=2, default=(0, HEIGHT),
                   metavar=("Y0", "Y1"))
    p.add_argument("--procs", type=int, default=min(os.cpu_count() or 1, 16))
    p.add_argument("--device", default="cuda",
                   help="cuda (the card's host), or cpu")
    args = p.parse_args(argv)
    dev = _sweep.device_of(args.device)
    rec = generate(args.out, args.rows, args.procs)
    rows = emit([rec], dev)
    if not rec["within_1e-6"]:
        raise SystemExit(1)
    return rows


if __name__ == "__main__":
    main()

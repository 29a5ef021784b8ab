"""K1 on the headline's ray sets, and K5's table-lookup forms against an
indexed read, in one process.

Counterpart of `tools/onehot_ab.py`.  The JAX tool A/Bs the TPU tracer's
one-hot extraction forms (`window_trace._OH_MODE`: a table read built
from compares and a matrix product, since the TPU kernel has no
per-lane gather), one process a form, timing the tracer on the bench
scene's primary and secondary ray sets.  The CUDA tracer (K1) reads its
grids with ordinary loads and has no such form, so this tool times:

  k1  K1 as it is on the headline camera's primary rays (1920x1080) and
      on the secondary set the JAX tool draws from their hits
      (`occupancy.hemisphere`, seed 0, in that order): ms a launch and
      Mrays/s (CUDA events over 10 launches);
  k5  the lookup s = sum_r table[r, code] carried through a dependent
      loop (`kernels/loop_probe`, the counterpart of
      tools/event_lab.py's one-hot bodies), at the tracer's lane count
      (one lane a primary ray: 2025 groups of 8 rows of 128) and at
      tables of 64 and 8 rows, in each of K5's forms (`onehot_smem`,
      `onehot_ldg`, `onehot_const`: the table in shared, global and
      constant memory) and as an indexed read in PyTorch (`indexed`,
      `loop_probe_plain`: `table[:, code]` summed); ns an iteration as
      the slope between two iteration counts.  Every form's final state
      (code, acc) after CHECK_ITERS iterations is held to the indexed
      read's: max |diff| 0.

    python -m wavefront_tpu_torch.tools.onehot_ab [--width 1920 \
        --height 1080] [--lanes 2073600] [--device cuda]

One JSON line a row, with the card's name and power limit; exits 1 when
a form differs from the indexed read.  Without a card it exits unless
given `--device cpu`, which runs the plain versions on the host clock.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from wavefront_tpu_torch.headline import HEADLINE_RAYS, headline_setup
from wavefront_tpu_torch.kernels import loop_probe as lp
from wavefront_tpu_torch.kernels.window_trace import auto_events, window_trace
from wavefront_tpu_torch.render.wavefront import raygen_soa
from wavefront_tpu_torch.tools import _sweep
from wavefront_tpu_torch.tools._timing import emit, time_ms
from wavefront_tpu_torch.tools.occupancy import hemisphere

FORMS = ("onehot_smem", "onehot_ldg", "onehot_const", "indexed")
TABLE_ROWS = (64, 8)
# rows of 128 lanes in a group (a thread block of 1024 lanes)
GROUP_ROWS = 8
# (lo, hi) iteration counts of the slope, per form and table rows
ITERS = {"onehot_smem": {64: (16, 128), 8: (64, 512)},
         "onehot_ldg": {64: (16, 128), 8: (64, 512)},
         "onehot_const": {64: (4, 16), 8: (8, 64)},
         "indexed": {64: (2, 6), 8: (2, 6)}}
CHECK_ITERS = 16


def ray_sets(scene, settings, basis):
    """{"primary": (o, d), "secondary": (o, d)} of the headline camera on
    the scene's device."""
    arrays = scene.get_arrays()
    dev = arrays.grid.device
    o, d, _ = raygen_soa(basis.eye, basis.front, basis.right, basis.up,
                         settings.width, settings.height, device=dev)
    hits = window_trace(arrays, o, d, auto_events(*arrays.grid.shape))
    return {"primary": (o, d), "secondary": hemisphere(o, d, *hits)}


def k1_rows(scene, settings, basis) -> list:
    arrays = scene.get_arrays()
    dev = arrays.grid.device
    events = auto_events(*arrays.grid.shape)
    out = []
    for name, (o, d) in ray_sets(scene, settings, basis).items():
        ms = time_ms(lambda: window_trace(arrays, o, d, events),
                     10 if dev.type == "cuda" else 1, dev)
        out.append({"row": "k1", "ray_set": name, "rays": int(o.x.shape[0]),
                    "live_rays": int(((d.x != 0) | (d.y != 0)
                                      | (d.z != 0)).sum()),
                    "ms": ms, "mrays_per_sec": o.x.shape[0] / ms / 1e3})
    return out


def run_form(form: str, state, table, iters: int):
    """The lookup loop in `form` on `state` = (code, acc)."""
    if form == "indexed":
        return lp.loop_probe_plain("onehot_smem", state, table, iters)
    return lp.loop_probe(form, state, table, iters)


def k5_state(lanes: int, dev, seed: int = 1):
    """(code, acc) of `lanes` lanes in groups of GROUP_ROWS rows of 128:
    codes drawn in [0, 128), acc 0."""
    rows = -(-lanes // 128)
    if rows % GROUP_ROWS:
        raise ValueError(f"onehot_ab: {lanes} lanes do not fill groups of "
                         f"{GROUP_ROWS * 128}")
    shape = (rows // GROUP_ROWS, GROUP_ROWS, 128)
    rng = np.random.default_rng(seed)
    code = torch.as_tensor(rng.integers(0, 128, shape).astype(np.int32),
                           device=dev)
    return code, torch.zeros_like(code)


def k5_rows(lanes: int, dev) -> list:
    rng = np.random.default_rng(2)
    state = k5_state(lanes, dev)
    out = []
    for nr in TABLE_ROWS:
        table = torch.as_tensor(rng.integers(0, 255, (nr, 128)).astype(
            np.uint8), device=dev)
        want = run_form("indexed", state, table, CHECK_ITERS)
        for form in FORMS:
            got = run_form(form, state, table, CHECK_ITERS)
            err = max(int((g - w).abs().max()) for g, w in zip(got, want))
            lo, hi = ITERS[form][nr]
            reps = 3 if dev.type == "cuda" else 1
            ms = [time_ms(lambda n=n: run_form(form, state, table, n), reps,
                          dev) for n in (lo, hi)]
            per_iter = (ms[1] - ms[0]) / (hi - lo)
            out.append({"row": "k5", "form": form, "table_rows": nr,
                        "lanes": int(state[0].numel()),
                        "groups": int(state[0].shape[0]),
                        "group_rows": GROUP_ROWS, "iters": [lo, hi],
                        "ns_per_iter": per_iter * 1e6,
                        "ns_per_lane_iter": per_iter * 1e6
                        / state[0].numel(),
                        "max_abs_diff_vs_indexed": err})
    return out


def ab(scene, settings, basis, lanes: int = HEADLINE_RAYS) -> list:
    """The k1 rows on the scene's device, then the k5 rows there."""
    return (k1_rows(scene, settings, basis)
            + k5_rows(lanes, torch.device(scene.device)))


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--lanes", type=int, default=HEADLINE_RAYS,
                   help="K5's lanes, a multiple of 1024")
    p.add_argument("--device", default="cuda",
                   help="cuda, or cpu for the plain versions")
    args = p.parse_args(argv)
    dev = _sweep.device_of(args.device)
    scene, settings, basis, _ = headline_setup(args.width, args.height,
                                               device=dev)
    rows = emit(ab(scene, settings, basis, args.lanes), dev)
    if any(r.get("max_abs_diff_vs_indexed", 0) != 0 for r in rows):
        raise SystemExit(1)
    return rows


if __name__ == "__main__":
    main()

"""What the labs share: the card's name, power limit and peak rates,
CUDA-event timing, and the slope between two iteration counts.

A lab measures the card, so it refuses to run without one
(`require_card`); nothing here falls back to the CPU.  The sweep tools
(`_sweep.py`) also print through `emit`, and run on the CPU when asked.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch


# groups of lanes that fill an H100 in the probe kernels: two blocks of 512
# threads for each of its 132 SMs
FILL_GROUPS = 264

# H100 SXM: the device memory rate of NVIDIA's data sheet, and the rate at
# which the card issues operations that are not fused: one per lane and
# clock, 132 SMs x 128 lanes x 1.98 GHz (event_lab's `issue` rows measure
# 3.3e13 a second).  The data sheet's 67 TFLOP/s of float32 counts a fused
# multiply-add as two operations; every kernel here is built with
# -fmad=false, so none of the operations the bounds count is fused, and
# that rate would make each bound 2x optimistic.  Integer operations issue
# at the same rate.
HBM_BYTES_PER_S = 3.35e12
UNFUSED_OPS_PER_S = 132 * 128 * 1.98e9
# the card's shared memory serves one 128-byte row of its 32 banks a clock
# on each SM; a load of fewer than 4 bytes still takes a bank's slot
SMEM_BYTES_PER_S = 132 * 128 * 1.98e9


def require_card() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this lab measures the card and "
                         "has nothing to say without one")


def card() -> tuple:
    """(name, power limit) of the first card, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    name, limit = out.stdout.strip().splitlines()[0].split(",", 1)
    return name.strip(), limit.strip()


def emit(rows, device="cuda") -> list:
    """Print each row as one JSON line with the card's name and power
    limit added (a run on the CPU adds "device": "cpu" instead); returns
    the rows as printed."""
    if torch.device(device).type == "cuda":
        name, limit = card()
        extra = {"card": name, "power_limit": limit}
    else:
        extra = {"device": "cpu"}
    out = []
    for row in rows:
        row = {**row, **extra}
        print(json.dumps(row), flush=True)
        out.append(row)
    return out


def _events():
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def sync(device="cuda") -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class _HostEvent:
    """A CUDA event's interface on the host clock, for CPU runs."""

    def record(self) -> None:
        self.t = time.perf_counter()

    def elapsed_time(self, end: "_HostEvent") -> float:
        return (end.t - self.t) * 1e3


def event(device="cuda"):
    """A timing event: a CUDA event on a card, the host clock on the
    CPU (where every op has finished when it returns)."""
    if torch.device(device).type == "cuda":
        return torch.cuda.Event(enable_timing=True)
    return _HostEvent()


def time_ms(fn, reps: int, device="cuda") -> float:
    """Mean time of `fn` over `reps` back-to-back calls after one warm-up
    call: CUDA events on a card, the host clock on the CPU."""
    fn()
    sync(device)
    e0, e1 = event(device), event(device)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    sync(device)
    return e0.elapsed_time(e1) / reps


def best_ms(fn, reps: int = 5) -> float:
    """Least device time of one call of `fn` among `reps`, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        e0, e1 = _events()
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        best = min(best, e0.elapsed_time(e1))
    return best


def time_slope(make, lo: int, hi: int, reps: int = 5) -> float:
    """Milliseconds per iteration as the slope between two iteration
    counts: `make(iters)` returns a function that runs `iters` iterations
    in one launch, so launch and set-up costs cancel."""
    return (best_ms(make(hi), reps) - best_ms(make(lo), reps)) / (hi - lo)

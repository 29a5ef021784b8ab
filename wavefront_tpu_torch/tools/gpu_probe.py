"""Is the card up, and what are its constants?

Counterpart of `tools/tpu_probe.py`.  `main()` makes one attempt to reach
the card and run a 128x128 matrix product, appends a JSON record to
`--log`, prints it, and exits 0 when the card is up and 1 when it is not.
With `--micro` the record also holds the microbenchmarks of `micro_suite`,
whose numbers are the constants the bounds in PERF.md divide by.

    python -m wavefront_tpu_torch.tools.gpu_probe [--micro] [--log PATH]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from wavefront_tpu_torch.kernels.device_probe import (
    loop_add,
    row_gather_sum,
    smem_capacity,
)
from wavefront_tpu_torch.tools._timing import (
    best_ms,
    card,
    time_ms,
    time_slope,
)


def _host_ms(fn, reps: int) -> float:
    """Host-clock milliseconds per call over `reps` calls that end in one
    synchronize (the launch path included), after two warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def micro_suite() -> dict:
    """The microbenchmarks, on the card: a dict of named numbers."""
    dev = "cuda"
    rng = np.random.default_rng(0)
    out = {}

    # dispatch: one tiny elementwise op, host clock
    x = torch.ones((8, 128), device=dev)
    out["dispatch_ms"] = _host_ms(lambda: x + 1.0, 20)

    # launch overhead in a dependent chain: 256 tiny ops, each on the last
    def chain256():
        a = torch.zeros((), device=dev)
        for _ in range(256):
            a = a + 1.0
        return a

    out["dependent_tiny_op_us"] = _host_ms(chain256, 5) / 256 * 1e3

    # a fat elementwise loop: 64 x 8 multiply-adds over 1M elements
    xb = torch.ones((1024, 1024), device=dev)

    def fat():
        a = xb
        for _ in range(64 * 8):
            a = a * 1.000001 + 0.5
        return a

    out["fat_loop_64x8_ms"] = _host_ms(fat, 5)

    # gathers: 1M random reads from a 1M-entry float32 table, and from a
    # grid-sized (819,200-entry) int32 table
    table = torch.as_tensor(rng.standard_normal(1 << 20).astype(np.float32),
                            device=dev)
    idx = torch.as_tensor(rng.integers(0, 1 << 20, 1 << 20), device=dev)
    out["gather_1M_ms"] = time_ms(lambda: table[idx].sum(), 5)
    table_s = torch.as_tensor(rng.integers(0, 127, 819200).astype(np.int32),
                              device=dev)
    idx_s = torch.as_tensor(rng.integers(0, 819200, 1 << 20), device=dev)
    out["gather_1M_small_table_ms"] = time_ms(lambda: table_s[idx_s].sum(), 5)

    # tensor cores: a 4096^3 bf16 product (a plain product, outside any
    # kernel of the port)
    a = torch.ones((4096, 4096), dtype=torch.bfloat16, device=dev)
    t_mm = time_ms(lambda: torch.matmul(a, a), 5)
    out["matmul4k_bf16_tflops"] = 2 * 4096 ** 3 / (t_mm * 1e-3) / 1e12

    # device memory: the 64 MB triad a = b + 1.5 c (two reads, one write)
    n = 1 << 24
    b, c = torch.ones(n, device=dev), torch.ones(n, device=dev)
    dst = torch.empty(n, device=dev)
    t_tr = time_ms(lambda: torch.add(b, c, alpha=1.5, out=dst), 10)
    out["triad_gbps"] = 3 * 4 * n / (t_tr * 1e-3) / 1e9

    # 16 chained 2M-entry gathers from a 102,400-entry table
    table2 = torch.as_tensor(rng.integers(0, 102399, 102400), device=dev)
    idx2 = torch.as_tensor(rng.integers(0, 102400, 1 << 21), device=dev)

    def chained():
        i = idx2
        for _ in range(16):
            i = table2[i]
        return i

    out["chained_gather_ns_per_lookup"] = (
        time_ms(chained, 3) * 1e6 / (16 * (1 << 21)))

    # the probe kernels: a dependent float32 add, a per-lane row gather
    # at four table heights, and the shared memory a block may have
    xp = torch.ones((512, 128), device=dev)
    out["loop_add_iter_ns"] = time_slope(
        lambda iters: (lambda: loop_add(xp, iters)), 4096, 65536) * 1e6
    for rows in (8, 512, 2048, 4096):
        t = torch.as_tensor(rng.integers(0, 100, (rows, 128)).astype(
            np.int32), device=dev)
        i = torch.as_tensor(rng.integers(0, rows, (rows, 128)).astype(
            np.int32), device=dev)
        per_rep = time_slope(
            lambda reps: (lambda: row_gather_sum(t, i, reps)), 1, 1024)
        out[f"row_gather_R{rows}_ns_per_lookup"] = (
            per_rep * 1e6 / (rows * 128))
        out[f"row_gather_R{rows}_us_per_op"] = per_rep * 1e3
        # one call that gathers once, timed alone: the wrapper's host
        # path and the launch latency included
        out[f"row_gather_R{rows}_us_one_call"] = best_ms(
            lambda: row_gather_sum(t, i, 1)) * 1e3
    out["smem_capacity"] = smem_capacity(dev)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--micro", action="store_true",
                    help="also run the microbenchmark suite")
    ap.add_argument("--log", default="gpu_probe.jsonl",
                    help="file the JSON record is appended to")
    args = ap.parse_args(argv)

    t0 = time.time()
    rec = {"ts": t0}
    try:
        if not torch.cuda.is_available():
            raise RuntimeError("torch.cuda.is_available() is false")
        rec["devices"] = [torch.cuda.get_device_name(i)
                          for i in range(torch.cuda.device_count())]
        rec["card"], rec["power_limit"] = card()
        ones = torch.ones((128, 128), device="cuda")
        y = torch.matmul(ones, ones)
        torch.cuda.synchronize()
        if float(y[0, 0]) != 128.0:
            raise RuntimeError(f"the 128x128 product gave {float(y[0, 0])}")
        rec["up"] = True
        rec["init_s"] = time.time() - t0
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        rec["up"] = False
        rec["error"] = str(e)[:300]
    if rec["up"] and args.micro:
        rec["micro"] = micro_suite()

    with open(args.log, "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(json.dumps(rec, indent=2))
    return 0 if rec["up"] else 1


if __name__ == "__main__":
    sys.exit(main())

"""A run of the harness on the CPU at a small size (the plain versions
of the kernels), for the tests."""

import time

from benchmark.harness import main as M

SMALL = {"width": 32, "height": 18}
TRAFFIC = {"check_pixels": 256, "warm_images": 1, "check_images": 2}


def cpu_run(cell, seed=3_000_000_019, seconds=1.0, trace=0, fault=None,
            settings=None, root=M.specmod.ROOT):
    args = M.parse(["--workload", cell, "--seed", str(seed), "--seconds",
                    str(seconds), "--trace", str(trace)])
    traffic = dict(TRAFFIC)
    if settings is not None:
        base = M.specmod.load_cell(cell, root).traffic["settings"]
        traffic["settings"] = {**base, **settings}
    return M.run(args, root, time.perf_counter(), device="cpu",
                 sizes=SMALL, traffic=traffic, fault=fault)

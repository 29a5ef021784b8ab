"""Run one cell of the benchmark (see benchmark/harness/main.py):

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# load from one process with few threads: the frame loop does its host
# work on one thread, and idle worker pools that spin between parallel
# host ops take cores from it on a shared host
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "2")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))

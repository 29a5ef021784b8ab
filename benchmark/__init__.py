"""The benchmark of the PyTorch and CUDA port (`wavefront_tpu_torch`).

`run.py` runs one cell of `BENCHMARK.json` for a seed and prints one JSON
line; `harness/` is the general machinery, and everything that belongs
to one configuration, traffic mix or metric sits in a file of its own
under `configs/`, `traffic/`, `end_to_end/` and `metrics/`, found by the
name `BENCHMARK.json` gives it.  `reference/` is the plain reference that
decides `correct`; `limits/` holds each cell's limits.
"""

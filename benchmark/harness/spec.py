"""What a cell is made of, found by name.

`BENCHMARK.json` at the root of the checkout names the cells; each name
leads to files of its own: `configs/<config>.json` (the sizes) and
`configs/<config>.py` (`build` of the system, `reference` of the scene),
`traffic/<traffic>.json` (the parameters the one generator reads),
`end_to_end/<metric>.py` and `metrics/<metric>.py` (one reader each) and
`limits/<cell>.json` (the check's limits).  A cell, a configuration, a
traffic mix or a metric is added by adding files and entries; nothing
here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass, field

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """A Python file as a module, by path (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    build: object            # the configuration's module
    end_to_end: list = field(default_factory=list)   # BENCHMARK.json entries
    per_layer: list = field(default_factory=list)
    limits: dict = field(default_factory=dict)


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of `root`/BENCHMARK.json, with everything its
    names lead to."""
    spec = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    conf = configs[w["config"]]
    bench = os.path.join(root, "benchmark")
    cfg = load_json(os.path.join(root, conf["file"]))
    mod = load_module(os.path.join(bench, "configs", w["config"] + ".py"),
                      "benchmark_config_" + w["config"])
    traffic = load_json(os.path.join(bench, "traffic",
                                     w["traffic"] + ".json"))
    e2e = [m for m in spec["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if _applies(m, name, reported)]
    lim_path = os.path.join(bench, "limits", name + ".json")
    limits = load_json(lim_path) if os.path.exists(lim_path) else {}
    return Cell(name, cfg, traffic, int(w["chips"]), mod, e2e, layer,
                limits)


def reader(kind: str, metric: str, root: str = ROOT):
    """The reader module of an end-to-end (`end_to_end`) or per-layer
    (`metrics`) metric."""
    return load_module(os.path.join(root, "benchmark", kind, metric + ".py"),
                       f"benchmark_{kind}_{metric.replace('.', '_')}")

"""The port's sweep tools (`wavefront_tpu_torch/tools/`: sort_sweep,
stage_table, fused_ab, texel_lab, trace_tune, occupancy, fusion_probe)
on the CPU, against the JAX tools they port (`tools/*.py`); and every
tool's `main`, the repository tools of tests/test_torch_repo_tools.py
too.

Each tool's row function runs on the headline scene at 16x16 to 32x32
(one timed frame) and gives the JAX tool's row names and keys, read from
the JAX tool's source (its schedules, variants, arms, workloads, stages
and the keys of its JSON rows); the sort schedules' images agree with the
every-bounce sort's within 1e-5.  Each `main` prints parseable JSON lines
with `--device cpu` at a small size and refuses `--device cuda` without
a card.  No JAX frame is rendered: the JAX tools are read, not run.
"""

import ast
import importlib
import importlib.util
import json
import os
import re

import pytest
import torch

from _torch_threads import one_thread  # noqa: F401
from wavefront_tpu_torch.headline import headline_setup
from wavefront_tpu_torch.tools import (
    fused_ab,
    fusion_probe,
    occupancy,
    sort_sweep,
    stage_table,
    texel_lab,
    trace_tune,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_source(name: str) -> str:
    with open(os.path.join(REPO, "tools", f"{name}.py")) as f:
        return f.read()


def jax_tool(name: str):
    """tools/<name>.py as a module (the root tools/ is not a package;
    these import JAX only inside their main)."""
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}",
                                                  os.path.join(REPO, "tools",
                                                               f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def dict_keys(src: str, target: str) -> set:
    """The string keys of every dict literal assigned to `target`."""
    keys = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(isinstance(t, ast.Name) and t.id == target
                        for t in node.targets):
            keys |= {k.value for k in node.value.keys}
    return keys


@pytest.fixture(scope="module")
def headline():
    return headline_setup(16, 16, 4, device="cpu")


def test_sort_sweep_rows(headline):
    rows = sort_sweep.sweep(*headline, frames=1)
    assert [r["row"] for r in rows] == [n for n, _ in
                                         jax_tool("sort_sweep").SCHEDULES]
    for r, sched in zip(rows, jax_tool("sort_sweep").SCHEDULES):
        assert r["sort_bounces"] == (None if sched[1] is None
                                     else list(sched[1]))
        assert {"row", "frame_ms"} <= set(r)
        assert r["max_abs_diff"] <= sort_sweep.IMAGE_TOLERANCE
        assert r["truncated"] == 0 and r["device_busy_ms"] is None
    assert [r["sorts"] for r in rows] == [4, 2, 2, 1, 0]


def test_stage_table_rows(headline):
    src = jax_source("stage_table")
    assert set(stage_table.ROWS) == dict_keys(src, "variants")
    assert {k for k, _, _ in stage_table.DERIVED} == set(
        re.findall(r'"derived": "(\w+)"', src))
    images = {}
    names = ("b1", "b2", "nosort", "dda")
    rows = stage_table.table(*headline, frames=1, names=names,
                             images=images)
    assert [r["row"] for r in rows[:4]] == list(names)
    assert rows[4] == {"derived": "bounce_marginal_ms",
                       "value": rows[1]["frame_ms"] - rows[0]["frame_ms"],
                       "device_value": None}
    for r in rows[:4]:
        assert {"row", "frame_ms"} <= set(r) and r["stage_ms"]
    # no sort and the unskipped march leave the image as it is
    assert rows[2]["max_abs_diff"] == rows[3]["max_abs_diff"] == 0.0
    assert "coherence_sort" not in rows[2]["stage_ms"]
    assert set(images) == set(names)


def test_fused_ab_rows(headline):
    arms = re.findall(r'\("(\w+)", dataclasses\.replace',
                      jax_source("fused_ab"))
    rows = fused_ab.ab(*headline, frames=1)
    assert [r["row"] for r in rows] == arms == ["fused", "xla"]
    assert "shade_pass" in rows[0]["stage_ms"]
    assert "texel_fetch" in rows[1]["stage_ms"]
    assert rows[0]["max_abs_diff"] < 1e-3


def test_trace_tune_rows(headline):
    jax_keys = dict_keys(jax_source("trace_tune"), "rec")
    rows = trace_tune.tune(*headline, frames=1, compaction=(1,),
                           skips=(1,), presort=(0, 1))
    assert len(rows) == 3 and rows[-1]["best"] in rows[:2]
    for r in rows[:2]:
        assert set(r) - {"presort", "device_busy_ms"} <= jax_keys
        assert {"compaction", "skips", "frame_ms", "truncated"} <= set(r)
        assert r["truncated"] == 0


def test_texel_lab_rows():
    src = jax_source("texel_lab")
    assert "xla gather" in src and "12ch" in src and " 8ch" in src
    rows = texel_lab.lab((300, 1 << 10), iters=1, dev="cpu")
    assert [r["row"] for r in rows] == ["gather", "12ch", "8ch"] * 2
    assert all(r["max_abs_diff"] == 0.0 and r["device_ms"] is None
               for r in rows)
    assert [r["n"] for r in rows] == [300] * 3 + [1024] * 3


def test_occupancy_rows(headline):
    doc = jax_tool("occupancy").__doc__
    assert all(re.search(rf"^\s+{w}\s", doc, re.M)
               for w in occupancy.WORKLOADS)
    scene, _, basis, _ = headline
    rows = occupancy.survey(32, 32, "cpu", ("primary", "secondary"),
                            headline=(scene, basis))
    assert [r["workload"] for r in rows] == ["primary", "secondary"]
    for r in rows:
        assert 0.0 < r["block_occupancy"] <= r["warp_occupancy"] <= 1.0
        assert r["fine"] + r["skips"] == round(
            r["steps_per_live_ray"] * r["live_rays"])
        assert r["truncated"] == 0
    assert rows[1]["live_rays"] < rows[0]["live_rays"] == 32 * 32


def test_lane_occupancy():
    steps = torch.tensor([4, 0, 2, 2, 1, 1, 1, 1, 5], dtype=torch.int32)
    # groups of 4: [4 0 2 2] [1 1 1 1] [5 0 0 0]: 17 / (4 * (4 + 1 + 5))
    assert occupancy.lane_occupancy(steps, 4) == 17 / 40


def test_fusion_probe_rows(headline):
    src = jax_source("fusion_probe")
    assert [s for s, _, _ in fusion_probe.STAGES] == re.findall(
        r'(?:tile_stats\([^"]*)"([^"]+)"\)', src)
    rows = fusion_probe.probe(*headline, tiles=(64, 16))
    assert [r["tile"] for r in rows] == [64, 16] * 3
    for r in rows:
        assert set(r) - {"tile"} == dict_keys(src, "rec")
        assert 0.0 <= r["alive_frac_mean"] <= 1.0
    # a re-sort gathers the alive rays into fewer tiles
    assert rows[4]["live_tiles"] <= rows[0]["live_tiles"]


MAINS = {
    "sort_sweep": ["--rows", "none", "--frames", "1", "--bounces", "2",
                   "--width", "16", "--height", "16"],
    "stage_table": ["--rows", "full", "--frames", "1", "--width", "16",
                    "--height", "16"],
    "fused_ab": ["--frames", "1", "--bounces", "1", "--width", "16",
                 "--height", "16"],
    "trace_tune": ["--compaction", "1", "--skips", "1", "--presort", "1",
                   "--frames", "1", "--width", "16", "--height", "16"],
    "texel_lab": ["--n", "100", "--iters", "1"],
    "occupancy": ["--only", "primary", "--width", "16", "--height", "16"],
    "fusion_probe": ["--tile", "64", "--width", "16", "--height", "16"],
    "gpu_parity": ["--bench", "--width", "16", "--height", "16", "--bounces",
                   "1"],
    "parity_probe": ["trace", "--width", "16", "--height", "16"],
    "gen_golden": ["--rows", "140", "141", "--procs", "1", "--out",
                   "{tmp}/golden.npz"],
    "gen_assets": ["--root", "{tmp}/assets"],
    "onehot_ab": ["--width", "16", "--height", "16", "--lanes", "1024"],
    "gpu_sweep": ["--stages", "bench", "--width", "16", "--height", "16"],
    "prewarm": ["--width", "16", "--height", "16", "--bounces", "1",
                "--batch", "1"],
}


def argv(tool: str, tmp_path) -> list:
    """MAINS[tool] with {tmp} made a fresh directory of the test's."""
    return [a.replace("{tmp}", str(tmp_path)) for a in MAINS[tool]]


@pytest.mark.parametrize("tool", sorted(MAINS))
def test_main_prints_json_on_the_cpu(tool, capsys, tmp_path):
    mod = importlib.import_module(f"wavefront_tpu_torch.tools.{tool}")
    printed = mod.main(argv(tool, tmp_path) + ["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    rows = [json.loads(line) for line in lines]
    assert rows == printed and rows
    assert all(r["device"] == "cpu" for r in rows)


@pytest.mark.parametrize("tool", sorted(MAINS))
def test_main_without_a_card_exits(tool, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"wavefront_tpu_torch.tools.{tool}")
    with pytest.raises(SystemExit, match="no CUDA device"):
        mod.main(argv(tool, tmp_path))

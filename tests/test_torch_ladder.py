"""The port's benchmark ladder (`wavefront_tpu_torch/tools/bench_ladder.py`)
against the JAX tool (`tools/bench_ladder.py`), on the CPU.

`build` of configs 1-5 gives the JAX tool's grid (exactly), origin, NEE
mode, camera and frame settings; the row function prints exactly the JAX
tool's keys (read from its source) at 32x32 for config 1 and for a
config-5-class frame (the primary cache, the accumulator, the batched
accumulating row); that row's k-frame mean equals the sum of k single
frames over k; `main` prints a config-1 row on the CPU and raises for
`--device cuda` without a card.  No JAX frame is rendered, and the
streamed window of configs 6-8 is not built here (its settings are held
by tests/test_torch_game.py and tests/test_torch_card_paths.py drives
it on the card).
"""

import ast
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401
from wavefront_tpu.core.camera import SphericalCamera as JaxCamera
from wavefront_tpu.world.blocks import BlockRegistry as JaxRegistry
from wavefront_tpu_torch.core.config import RenderingPreferences
from wavefront_tpu_torch.render.accumulate import TemporalAccumulator
from wavefront_tpu_torch.render.renderer import Renderer, use_fused
from wavefront_tpu_torch.tools import bench_ladder
from wavefront_tpu_torch.world.blocks import BlockRegistry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOL = os.path.join(REPO, "tools", "bench_ladder.py")
ASSETS = os.path.join(REPO, "assets")
SETTINGS_FIELDS = ("width", "height", "num_bounces", "scale", "jitter",
                   "max_trace_steps", "cache_primary", "trace_audit",
                   "compaction")


@pytest.fixture(scope="module")
def jax_ladder():
    """tools/bench_ladder.py (the root tools/ is not a package)."""
    spec = importlib.util.spec_from_file_location("jax_tools_bench_ladder",
                                                  JAX_TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def registry():
    return BlockRegistry.load(ASSETS)


def jax_row_keys() -> dict:
    """The keys of the JAX tool's rows, read from its source: the dict
    that opens a row, and each `rec["..."] = ` after it, grouped as the
    audit, recenter and batched keys."""
    with open(JAX_TOOL) as f:
        tree = ast.parse(f.read())
    base, later = set(), set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        for tgt in node.targets:
            if isinstance(tgt, ast.Name) and tgt.id == "rec" \
                    and isinstance(node.value, ast.Dict):
                base |= {k.value for k in node.value.keys}
            elif isinstance(tgt, ast.Subscript) \
                    and isinstance(tgt.value, ast.Name) \
                    and tgt.value.id == "rec":
                later.add(tgt.slice.value)
    groups = {"base": base,
              "recenter": {k for k in later if k.startswith("recenter_")},
              "batched": {k for k in later if k.startswith("batch")}}
    groups["audit"] = later - groups["recenter"] - groups["batched"]
    return groups


def test_the_jax_tool_keys_are_grouped():
    keys = jax_row_keys()
    assert keys["base"] == {"config", "frame_ms", "mrays_per_sec",
                            "compile_s"}
    assert keys["audit"] == {"truncated_rays", "nee_overflow_rays"}
    assert keys["batched"] == {"batched_frame_ms", "batched_mrays_per_sec",
                               "batch_k"}
    assert len(keys["recenter"]) == 4


@pytest.mark.parametrize("config", [1, 2, 3, 4, 5])
def test_build_matches_the_jax_tool(jax_ladder, registry, config):
    """Same grid, origin, NEE mode, camera and settings as the JAX tool's
    `build` (configs 1 and 2: its default pose)."""
    jscene, jcm, jsettings, jnee, jbasis = jax_ladder.build(
        config, JaxRegistry.load(ASSETS))
    scene, cm, settings, nee, basis = bench_ladder.build(config, registry,
                                                         device="cpu")
    np.testing.assert_array_equal(scene.grid, jscene.grid)
    assert scene.grid_origin == tuple(int(v) for v in jscene.grid_origin)
    assert cm is jcm is None
    assert nee == jnee
    for f in SETTINGS_FIELDS:
        assert getattr(settings, f) == getattr(jsettings, f), f
    if config in (1, 2):
        assert basis is jbasis is None
        cam = JaxCamera()
        cam.set_root_position([0.0, 12.0, 0.0])
        cam.offset, cam.yaw, cam.pitch = 28.0, 0.6, -0.35
        basis, jbasis = bench_ladder.default_pose(), cam.eye_front_right_up()
        # one lamp in the chunk: K2 takes the fused path at nee_type 0
        arrays = scene.get_arrays()
        assert arrays.lights.num_prims == 6
        assert use_fused(arrays, settings, nee)
    for f in ("eye", "front", "right", "up"):
        np.testing.assert_array_equal(getattr(basis, f), getattr(jbasis, f))


def small(config, registry):
    """A config's scene and settings at 32x32 on the CPU, with its pose
    and preferences."""
    scene, cm, settings, nee, basis = bench_ladder.build(config, registry,
                                                         device="cpu")
    return (scene, settings.replace(width=32, height=32),
            bench_ladder.default_pose() if basis is None else basis,
            RenderingPreferences(nee_type=nee))


@pytest.mark.parametrize("config,groups", [
    (1, ("base", "batched")),
    (5, ("base", "audit", "batched")),
])
def test_row_keys_match_the_jax_tool(registry, config, groups):
    scene, settings, basis, prefs = small(config, registry)
    rec = bench_ladder.row(config, scene, settings, basis, prefs, frames=1,
                           batch=2)
    keys = jax_row_keys()
    assert set(rec) == set().union(*(keys[g] for g in groups))
    assert rec["config"] == config and rec["batch_k"] == 2
    assert all(np.isfinite(v) for v in rec.values())
    if config == 5:
        assert rec["truncated_rays"] == rec["nee_overflow_rays"] == 0


def test_accumulating_batch_equals_the_mean_of_single_frames(registry):
    """Config 5's batched row: `render_batch(k, accumulate=True)` on a
    `cache_primary` renderer equals k `render` calls of a second one,
    summed in frame order and divided by k, bit for bit; and the loop's
    accumulator holds their running mean."""
    scene, settings, basis, prefs = small(5, registry)
    settings = settings.replace(num_bounces=3)
    k = 3
    mean = Renderer(settings, device="cpu").render_batch(
        scene, basis, prefs, 0, k=k, accumulate=True, as_numpy=False)
    single = Renderer(settings, device="cpu")
    frames = [single.render(scene, basis, prefs, frame_count=f,
                            as_numpy=False) for f in range(k)]
    total = frames[0]
    for img in frames[1:]:
        total = total + img
    assert torch.equal(mean, total / float(k))
    step = bench_ladder.frame_step(
        5, scene, None, Renderer(settings, device="cpu"), basis, prefs,
        TemporalAccumulator())
    acc = [step(f) for f in range(k)][-1]
    torch.testing.assert_close(acc, total / float(k), rtol=1e-6, atol=1e-6)


def test_edit_step_places_and_breaks_a_block(registry):
    """Config 4's frame: stone at odd frame counts, air at even ones, at
    (8 + f % 16, 20, 3) of the headline grid, before the render."""
    scene, settings, basis, prefs = small(4, registry)
    step = bench_ladder.frame_step(
        4, scene, None, Renderer(settings.replace(width=8, height=8),
                                 device="cpu"), basis, prefs)
    stone = registry.block_idx("stone")
    assert stone == 5
    for f in (1, 2):
        img = step(f)
        assert img.shape == (8, 8, 3)
        want = stone if f % 2 else registry.air
        assert scene.get_block((8 + f % 16, 20, 3)) == want


def test_main_prints_a_row_on_the_cpu(capsys):
    bench_ladder.main(["--configs", "1", "--frames", "1", "--batch", "2",
                       "--device", "cpu"])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert len(rows) == 1 and rows[0]["config"] == 1
    keys = jax_row_keys()
    assert set(rows[0]) == keys["base"] | keys["batched"]


def test_main_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        bench_ladder.main(["--configs", "1", "--device", "cuda"])

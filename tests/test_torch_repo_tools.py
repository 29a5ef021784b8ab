"""The port's last repository tools (`wavefront_tpu_torch/bench.py` and
`wavefront_tpu_torch/tools/`: gen_golden, gen_assets, parity_probe,
gpu_parity, gpu_sweep, onehot_ab) on the CPU at small sizes.

They are held against stored files, the JAX tools' own gate code, or
the port itself: the oracle's rows and the golden frame against
tests/golden/config1_256.npz, the asset pack against assets/, the image
gates (`gpu_parity.compare`, `parity_probe._cmp`) against
tools/tpu_parity.py's `_compare` and tools/parity_probe.py's `_cmp` (pure
NumPy; the files are loaded, no JAX frame is rendered), K5's forms
against a NumPy restatement of the lookup loop.  On the CPU the parity
probes' card and CPU sides are one path, so those rows show the probes
run and report; their gates are the functions held to the JAX tools.
`gpu_sweep` runs with its subprocesses and its probe faked, and its
queue is read against the JAX tool's (tools/tpu_sweep.py, parsed, not
run).
"""

import ast
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from _torch_threads import one_thread  # noqa: F401
from wavefront_tpu_torch import bench
from wavefront_tpu_torch.core.config import RenderSettings
from wavefront_tpu_torch.headline import config1_grid, config1_pose
from wavefront_tpu_torch.kernels import loop_probe
from wavefront_tpu_torch.render import lights as lights_mod
from wavefront_tpu_torch.render.oracle import OracleRenderer
from wavefront_tpu_torch.tools import (
    gen_assets,
    gen_golden,
    gpu_parity,
    gpu_sweep,
    onehot_ab,
    parity_probe,
)
from wavefront_tpu_torch.world.blocks import BlockRegistry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets")


def _jax_tool(name: str):
    """tools/<name>.py (the root tools/ is not a package); its gate
    functions are pure NumPy and import JAX only when run."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_tpu_parity():
    return _jax_tool("tpu_parity")


@pytest.fixture(scope="module")
def jax_parity_probe():
    return _jax_tool("parity_probe")


def _hdr_pair(seed: int, divergent: bool):
    """(got, want): a seeded 24x24 HDR radiance image (want: [0, 1]
    pixels, and emissive ones at 640-680 as the lamp faces reach), and
    `got` within a few float32 ulps of it; with `divergent`, a few dark
    pixels off by 2e-3, emissive ones off by 1.5e-3 of their value, and
    emissive ones off by 7e-4 (relative: these agree)."""
    rng = np.random.default_rng(seed)
    want = rng.uniform(0.0, 1.0, (24, 24, 3)).astype(np.float32)
    lamp = rng.random((24, 24)) < 0.15
    want[lamp] = rng.uniform(640.0, 680.0, (int(lamp.sum()), 3))
    got = want * (1 + rng.uniform(-4e-7, 4e-7, want.shape)).astype(
        np.float32)
    if divergent:
        dark, bright = np.flatnonzero(~lamp), np.flatnonzero(lamp)
        flat = got.reshape(-1, 3)
        for i in rng.choice(dark, 3, replace=False):
            flat[i, rng.integers(3)] += 2e-3
        picks = rng.choice(bright, 4, replace=False)
        for i in picks[:2]:
            flat[i, 0] *= 1 + 1.5e-3
        for i in picks[2:]:
            flat[i, 2] *= 1 + 7e-4
    return got.astype(np.float32), want


@pytest.mark.parametrize("divergent", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compare_equals_the_jax_tools(seed, divergent, jax_tpu_parity,
                                      jax_parity_probe):
    """gpu_parity.compare is tpu_parity._compare (which rounds its floats
    to 8 digits) and parity_probe._cmp is the JAX tool's _cmp, on the
    same seeded HDR images."""
    got, want = _hdr_pair(seed, divergent)
    mine = gpu_parity.compare(got, want)
    theirs = jax_tpu_parity._compare(got, want)
    assert set(mine) == set(theirs)
    for k, v in theirs.items():
        assert (round(mine[k], 8) if isinstance(mine[k], float)
                else mine[k]) == v, k
    assert mine["divergent_count"] == (5 if divergent else 0)
    assert parity_probe._cmp("t", got, want) \
        == jax_parity_probe._cmp("t", got, want)


def test_gen_golden_band_equals_the_stored_rows(tmp_path):
    """Rows 140-143 (lit: the lamp and the grass) of the 256x256 golden,
    by the port's oracle, equal the stored image's."""
    rec = gen_golden.generate(str(tmp_path / "band.npz"), (140, 143))
    want = np.load(gen_golden.GOLDEN)["image"][140:143]
    got = np.load(tmp_path / "band.npz")
    assert got["image"].shape == want.shape
    assert np.all(np.abs(got["image"] - want)
                  <= 1e-6 * np.maximum(1.0, np.abs(want)))
    assert list(got["rows"]) == [140, 143]
    assert rec["within_1e-6"] and rec["mean"] > 1.0


@pytest.mark.parametrize("nee_type", [0, 1])
def test_band_carving_equals_the_oracle_frame(nee_type):
    """Bands of an 8x8 frame, put together, equal OracleRenderer.render
    given the camera's vectors in float64, as the bands take them (the
    stored golden's rays were made in float64)."""
    reg = BlockRegistry.load(ASSETS)
    grid = config1_grid(reg)
    ls = lights_mod.build_from_grid(grid, np.zeros(3), reg, 256)
    oracle = OracleRenderer(RenderSettings(width=8, height=8, num_bounces=2,
                                           max_trace_steps=96),
                            reg, grid, (0, 0, 0), ls)
    basis = config1_pose()
    whole = oracle.render(*(np.asarray(getattr(basis, k), np.float64)
                            for k in ("eye", "front", "right", "up")), 0,
                          nee_type)
    bands = np.concatenate([gen_golden.render_rows(oracle, basis, y0, y1,
                                                   nee_type)
                            for y0, y1 in ((0, 3), (3, 8))])
    assert whole.any() and np.array_equal(bands, whole)


def test_gen_golden_refuses_the_stored_golden():
    with pytest.raises(SystemExit, match="tests/golden"):
        gen_golden.generate(gen_golden.GOLDEN, (140, 141))


def test_gen_assets_equals_the_assets(tmp_path):
    files = gen_assets.generate(str(tmp_path))
    rec = gen_assets.compare(str(tmp_path), files)
    with open(tmp_path / "blocks.json", "rb") as a, \
            open(os.path.join(ASSETS, "blocks.json"), "rb") as b:
        assert a.read() == b.read()
    assert rec["pass"] and rec["missing"] == []
    assert rec["textures"] == rec["reference_textures"] \
        == rec["rgba_equal_textures"] == 44
    # the registry loads the generated pack into the same atlas
    assert np.array_equal(BlockRegistry.load(str(tmp_path)).atlas,
                          BlockRegistry.load(ASSETS).atlas)


@pytest.mark.parametrize("root", ["", "blocks"])
def test_gen_assets_refuses_the_assets(root):
    with pytest.raises(SystemExit, match="assets/"):
        gen_assets.generate(os.path.join(ASSETS, root))


@pytest.mark.parametrize("cmd", parity_probe.CMDS)
def test_parity_probe_cpu_against_cpu(cmd):
    rows = parity_probe.COMMANDS[cmd](torch.device("cpu"), 48, 48)
    assert rows
    for r in rows:
        for key in ("divergent", "mismatch", "hit", "face", "owner",
                    "entered", "vx_hitlanes", "vy_hitlanes", "vz_hitlanes"):
            assert r.get(key, 0) == 0, r
        assert r.get("golden_gate", {"pass": True})["pass"]
    if cmd == "trace":
        assert rows[0]["n"] == 48 * 48
    if cmd == "split":
        assert [r["check"] for r in rows] == ["nee1 cpu vs cpu",
                                              "nee0 cpu vs cpu"]


def test_parity_probe_arms_at_the_golden_size():
    """At 256x256 the three arms hold the stored golden."""
    rows = parity_probe.arms(torch.device("cpu"))
    checks = {r["check"]: r for r in rows}
    for arm in ("fused", "general+texel", "general+gather"):
        assert checks[f"{arm} vs_golden"]["divergent"] == 0


def test_gpu_parity_bench_gate_on_the_cpu():
    from wavefront_tpu_torch.headline import headline_setup

    rec = gpu_parity.bench_gate(*headline_setup(96, 54, 2, device="cpu"))
    assert rec["pass"] and rec["truncated_rays"] == 0
    assert rec["nee_overflow_rays"] == 0
    assert rec["divergent_count"] == 0


def test_gpu_parity_bench_gate_fails_on_a_cut_tracer():
    """With the tracer's budget cut to 8 events the audit counts truncated
    rays and the image leaves the 512-step reference: the gate fails."""
    from wavefront_tpu_torch.headline import headline_setup

    scene, settings, basis, prefs = headline_setup(96, 54, 2, device="cpu")
    rec = gpu_parity.bench_gate(scene, settings.replace(trace_events=8),
                                basis, prefs)
    assert not rec["pass"] and rec["truncated_rays"] > 0
    assert rec["divergent_count"] > 0


def test_gpu_parity_golden_check_on_the_cpu():
    """The default check: the golden frame, through the Renderer, held to
    the stored golden."""
    rec = gpu_parity.golden_check(torch.device("cpu"))
    assert rec["pass"] and rec["divergent_count"] == 0
    assert rec["config"] == "config 1 (256x256x1, nee=1)"


def test_parity_probe_fields_count_mismatches():
    rng = np.random.default_rng(5)
    a = {"hit": torch.as_tensor(rng.random(64) < 0.5),
         "t": torch.as_tensor(rng.random(64, dtype=np.float32))}
    b = {k: v.clone() for k, v in a.items()}
    b["hit"][[3, 9]] = ~b["hit"][[3, 9]]
    b["t"][7] += 0.25
    rows = parity_probe._fields("f", a, b)
    assert [(r["field"], r["mismatch"], r["of"]) for r in rows] == [
        ("hit", 2, 64), ("t", 1, 64)]
    assert "max_abs" not in rows[0]
    assert rows[1]["max_abs"] == pytest.approx(0.25, abs=1e-6)


def test_gpu_parity_compare_is_relative():
    want = np.zeros((2, 2, 3), np.float32)
    want[0, 0] = 500.0
    got = want.copy()
    got[0, 0] += 0.4          # 8e-4 of 500: agrees
    got[1, 1] += 2e-3         # 2e-3 on a dark pixel: diverges
    rec = gpu_parity.compare(got, want)
    assert rec["divergent_count"] == 1
    assert rec["frac_divergent_pixels"] == 0.25 and not rec["pass"]


def test_bench_prints_one_line(capsys):
    rows = bench.main(["--device", "cpu", "--width", "64", "--height", "36",
                       "--bounces", "2", "--batch", "2", "--frames", "2"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and [json.loads(lines[0])] == rows
    rec = rows[0]
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "frame_ms",
                        "card", "power_limit", "device"}
    assert rec["metric"] == "Mrays_per_sec" and rec["unit"] == "Mray/s"
    assert rec["device"] == "cpu" and rec["card"] is None
    assert rec["value"] == pytest.approx(64 * 36 * 2 / rec["frame_ms"] / 1e3)
    assert rec["vs_baseline"] == pytest.approx(rec["value"] / 1000.0)


def _jax_queue() -> list:
    """(script and flags, time limit) of every `run` call of
    tools/tpu_sweep.py's main, in order."""
    with open(os.path.join(REPO, "tools", "tpu_sweep.py")) as f:
        tree = ast.parse(f.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    out = []
    for node in ast.walk(main):
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") \
                == "run":
            words = [e.value for e in node.args[0].elts
                     if isinstance(e, ast.Constant)]
            limit = eval(compile(ast.Expression(node.keywords[0].value),
                                 "tpu_sweep", "eval"))
            out.append((node.lineno, words, limit))
    return [(words, limit) for _, words, limit in sorted(out)]


# the JAX tool's scripts and their ports
PORTED = {"tools/tpu_parity.py": "wavefront_tpu_torch.tools.gpu_parity",
          "bench.py": "wavefront_tpu_torch.bench",
          "tools/bench_ladder.py": "wavefront_tpu_torch.tools.bench_ladder",
          "tools/occupancy.py": "wavefront_tpu_torch.tools.occupancy"}


@pytest.fixture
def faked_sweep(monkeypatch):
    """gpu_sweep with a card, a probe, subprocesses and emit faked."""
    calls = {"run": [], "probe": [True], "exit": 0}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(gpu_sweep, "probe",
                        lambda timeout=90: calls["probe"].pop(0))
    monkeypatch.setattr(gpu_sweep, "emit", lambda rows, dev: list(rows))

    def run(cmd, timeout):
        calls["run"].append((cmd, timeout))
        return calls["exit"], 0.0

    monkeypatch.setattr(gpu_sweep, "run", run)
    return calls


def test_gpu_sweep_queues_the_jax_tools_commands(faked_sweep):
    rows = gpu_sweep.main(["--stages", "occ", "ladder", "bench", "gates",
                           "--configs", "3", "5", "--frames", "2"])
    want = _jax_queue()
    got = faked_sweep["run"]
    assert len(got) == len(want) == len(rows) == 5
    for (cmd, limit), (words, jax_limit) in zip(got, want):
        assert cmd[1:3] == ["-m", PORTED[words[0]]]
        assert limit == jax_limit
        assert [w for w in cmd[3:] if w.startswith("--")] == words[1:]
    assert got[3][0][3:] == ["--configs", "3", "5", "--frames", "2"]
    assert [r["stage"] for r in rows] == ["gates", "gates", "bench",
                                          "ladder", "occ"]
    assert all(r["exit"] == 0 for r in rows)


def test_gpu_sweep_exits_2_when_the_card_is_down(faked_sweep):
    faked_sweep["probe"] = [False]
    with pytest.raises(SystemExit) as e:
        gpu_sweep.main(["--stages", "gates"])
    assert e.value.code == 2 and faked_sweep["run"] == []


def test_gpu_sweep_waits_for_the_card(faked_sweep, monkeypatch):
    faked_sweep["probe"] = [False, False, True]
    monkeypatch.setattr(gpu_sweep.time, "sleep", lambda s: None)
    gpu_sweep.main(["--stages", "bench", "--wait"])
    assert faked_sweep["probe"] == [] and len(faked_sweep["run"]) == 1


def test_gpu_sweep_exits_1_when_a_stage_fails(faked_sweep):
    faked_sweep["exit"] = 1
    with pytest.raises(SystemExit) as e:
        gpu_sweep.main(["--stages", "gates"])
    assert e.value.code == 1 and len(faked_sweep["run"]) == 2


def test_onehot_ab_forms_equal_the_indexed_read():
    forms = [f for f in onehot_ab.FORMS if f != "indexed"]
    assert set(forms) == {v for v in loop_probe.VARIANTS
                          if v.startswith("onehot")}
    rows = onehot_ab.k5_rows(2048, torch.device("cpu"))
    assert [(r["form"], r["table_rows"]) for r in rows] == [
        (f, n) for n in onehot_ab.TABLE_ROWS for f in onehot_ab.FORMS]
    assert all(r["max_abs_diff_vs_indexed"] == 0 for r in rows)
    # every form's state after CHECK_ITERS iterations is a NumPy
    # restatement's (the forms' plain versions are held to the TPU loop
    # kernel in test_torch_probes.py)
    rng = np.random.default_rng(3)
    code, acc = onehot_ab.k5_state(2048, "cpu")
    for nr in onehot_ab.TABLE_ROWS:
        table = rng.integers(0, 255, (nr, 128)).astype(np.uint8)
        c, a = code.numpy().copy(), acc.numpy().copy()
        for _ in range(onehot_ab.CHECK_ITERS):
            s = table.astype(np.int32)[:, c].sum(0)
            c, a = (c + s % 2 + 1) % 128, a + s
        for form in onehot_ab.FORMS:
            got = onehot_ab.run_form(form, (code, acc), torch.as_tensor(
                table), onehot_ab.CHECK_ITERS)
            assert np.array_equal(got[0].numpy(), c), form
            assert np.array_equal(got[1].numpy(), a), form
    # the indexed read is the lookup itself
    code, acc = onehot_ab.k5_state(1024, "cpu")
    table = torch.arange(8 * 128, dtype=torch.int32).reshape(8, 128) % 251
    c1, a1 = onehot_ab.run_form("indexed", (code, acc),
                                table.to(torch.uint8), 1)
    s = table[:, code.long()].sum(0)
    assert torch.equal(a1, s) and torch.equal(c1, (code + s % 2 + 1) % 128)

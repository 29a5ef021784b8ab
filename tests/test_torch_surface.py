"""The port's public surface holds the JAX package's, read from source.

Both trees are parsed with `ast`; nothing is imported.  For every module
of `wavefront_tpu/`, the module of the same path under
`wavefront_tpu_torch/` must have

  * every public top-level function and class, and every public method
    (and `__init__`) of those classes, under the same name;
  * every parameter name of each of them (a `**kwargs` that a function
    hands on to another function of the port counts as that function's
    parameters);

and every `add_argument` flag of the repository's `tools/*.py` and
`bench.py` must be on its counterpart under `wavefront_tpu_torch/`.

Two tables may excuse an entry, and no other: `RENAMED` (a JAX name and
the port's name for the same function, with the parity test that holds
the two equal) and `TPU_ONLY` (a TPU schedule, with what stands for it in
the port).  An entry of either is stale, and fails, once the JAX package
no longer has the name or the port has it.
"""

import ast
import functools
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX = ROOT / "wavefront_tpu"
PORT = ROOT / "wavefront_tpu_torch"

# repository tool -> the port's tool module (wavefront_tpu_torch/tools/)
TOOL_NAMES = {"tpu_parity": "gpu_parity", "tpu_probe": "gpu_probe",
              "tpu_sweep": "gpu_sweep"}

# "module::JAX name" -> (the port's name, "test file::test" holding both
# equal on the same inputs)
RENAMED = {
    "core/rng.py::murmur3_combine": (
        "combine", "tests/test_torch_rng.py::test_combine_bitexact"),
    "core/rng.py::murmur3_finalize": (
        "finalize", "tests/test_torch_rng.py::test_finalize_bitexact"),
    "core/rng.py::murmur3_finalizef": (
        "finalizef", "tests/test_torch_rng.py::test_finalizef_bitexact"),
    "core/rng.py::murmur3_combinef": (
        "combinef", "tests/test_torch_rng.py::test_combinef_bitexact"),
}

_WT = ("the TPU tracer's {}; the port's tracer walks the dense aux grid "
       "one thread a ray (kernels/window_trace.py)")
_FLAG = ("the TPU tracer's {}, swept; K1 runs one thread a ray, with no "
         "tile, window or phase to set")
# "module::name", "module::name(parameter)" or "tool --flag" -> the TPU
# schedule it is, and the port's counterpart
TPU_ONLY = {
    # the deduplicated 32^3 window blocks and their DMA
    "kernels/window_trace.py::WindowPack": _WT.format(
        "deduplicated 32^3 window blocks, the port's `scene` argument"),
    "kernels/window_trace.py::WindowTables": _WT.format(
        "window-block tables"),
    "kernels/window_trace.py::build_window_tables": _WT.format(
        "window-block table build"),
    "kernels/window_trace.py::build_window_pack": _WT.format(
        "window-pack build; the scene's aux grid stands for it"),
    "kernels/window_trace.py::PackBuilder": _WT.format(
        "incremental window-pack edits; scene edits refresh the aux grid"),
    "kernels/window_trace.py::auto_events(pack)": _WT.format(
        "budget read off a WindowPack; the port's takes the grid's shape"),
    # the TPU kernels' tile, window and phase schedules
    "kernels/window_trace.py::window_trace(pack)": _WT.format(
        "WindowPack; the port takes `scene` (grid, aux grid, origin)"),
    "kernels/window_trace.py::window_trace(tile)": _WT.format(
        "rays per grid step"),
    "kernels/window_trace.py::window_trace(windows)": _WT.format(
        "resident windows an event"),
    "kernels/window_trace.py::window_trace(presort)": _WT.format(
        "coherence sort of a launch's rays into its tiles (no result "
        "changes); the port's is the renderer's bounce sort"),
    "kernels/window_trace.py::window_trace(presorted)": _WT.format(
        "phase-0 sort skip, which only phases read"),
    "kernels/window_trace.py::window_trace(phases)": _WT.format(
        "straggler phases (re-sort and resume)"),
    "kernels/window_trace.py::window_trace(phase_events)": _WT.format(
        "per-phase budget"),
    "kernels/window_trace.py::window_trace(unroll)": _WT.format(
        "unrolled event loop"),
    "kernels/window_trace.py::window_trace(skip_stride)": _WT.format(
        "skip test every k events"),
    "kernels/window_trace.py::window_trace(skips)": _WT.format(
        "empty-space skip switch (no result changes); the port's march "
        "without skips is an aux grid without distances, `aux_grid & 3`, "
        "as RenderSettings(trace_skips=False) gives it"),
    "kernels/window_trace.py::window_trace(wskip)": _WT.format(
        "whole-window skip"),
    "kernels/window_trace.py::window_trace(interpret)": _WT.format(
        "Pallas interpret mode; a CPU tensor takes `trace_plain`"),
    "kernels/window_trace.py::window_trace(with_stats)": _WT.format(
        "per-tile MXU visit and prefetch counters; `trace_plain(stats=)` "
        "counts the port's steps"),
    "kernels/window_trace.py::window_trace(tables_in_hbm)": _WT.format(
        "window tables in VMEM or HBM"),
    "kernels/shade.py::shade_pass(tile)": (
        "the TPU shade's rays per grid step; the port's K2 runs a thread "
        "a ray (csrc/shade.cu)"),
    "kernels/shade.py::shade_pass(interpret)": (
        "Pallas interpret mode; a CPU tensor takes `shade_plain`"),
    "kernels/texel.py::texel_fetch(tile)": (
        "the TPU texel fetch's rays per grid step; the port's K3 runs a "
        "thread a ray (csrc/texel.cu)"),
    "kernels/texel.py::texel_fetch(interpret)": (
        "Pallas interpret mode; a CPU tensor takes `texel_plain`"),
    "render/renderer.py::render_frame(ray_sharding)": (
        "the GSPMD sharding of the ray axis over a TPU mesh; the port's "
        "counterpart is `pixels=(lo, hi)`, a range of one mesh entry"),
    "render/renderer.py::render_frame_batch(ray_sharding)": (
        "render_frame's ray_sharding, which render_frame_batch hands on"),
    # the tools' TPU schedule flags
    "tools/bench_ladder.py --platform": (
        "the JAX platform (TPU or CPU); the port's tool takes --device"),
    "tools/occupancy.py --tiles": _FLAG.format("tile sizes swept"),
    "tools/occupancy.py --windows": _FLAG.format("resident windows"),
    "tools/occupancy.py --phases": _FLAG.format("straggler phases"),
    "tools/texel_lab.py --tiles": (
        "the TPU texel fetch's tile sizes; K3 runs one thread a ray"),
    "tools/trace_tune.py --tiles": _FLAG.format("tile sizes"),
    "tools/trace_tune.py --windows": _FLAG.format("resident windows"),
    "tools/trace_tune.py --windows-hot": _FLAG.format(
        "resident windows on the hot bounce"),
    "tools/trace_tune.py --phases": _FLAG.format("straggler phases"),
    "tools/trace_tune.py --phases-at": _FLAG.format(
        "bounces that run phases"),
    "tools/trace_tune.py --phase-events": _FLAG.format("per-phase budget"),
    "tools/trace_tune.py --unroll": _FLAG.format("unrolled event loop"),
    "tools/trace_tune.py --skip-strides": _FLAG.format(
        "stride of the skip test"),
    "tools/trace_tune.py --wskips": _FLAG.format("whole-window skip"),
}


def _params(fn: ast.FunctionDef) -> list:
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
            if x.arg not in ("self", "cls")]


def _forwards(fn: ast.FunctionDef) -> list:
    """Names of the functions that `fn` calls with its own **kwargs."""
    kw = fn.args.kwarg.arg if fn.args.kwarg else None
    if kw is None:
        return []
    out = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and any(k.arg is None and isinstance(k.value, ast.Name)
                        and k.value.id == kw for k in node.keywords):
            out.append(node.func.id)
    return out


def _module_path(root: Path, dotted: str) -> Path:
    rel = Path(*dotted.split(".")[1:])
    pkg = root / rel / "__init__.py"
    return pkg if pkg.exists() else (root / rel).with_suffix(".py")


def _root_of(path: Path) -> Path:
    return PORT if PORT in path.parents else JAX


@functools.lru_cache(maxsize=None)
def surface(path: Path, text: str = None) -> dict:
    """{qualified name: parameter names, or None for a class} of a module
    (of `text` in its place when given): its public functions, classes
    and their methods, and, in the port, the names it imports from its
    own package (re-exports, resolved to their definitions)."""
    root = _root_of(path)
    tree = ast.parse(path.read_text() if text is None else text)
    out, defs, imported = {}, {}, {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef):
            defs[node.name] = node
            if not node.name.startswith("_"):
                out[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            out[node.name] = None
            for m in node.body:
                if isinstance(m, ast.FunctionDef) and (
                        not m.name.startswith("_") or m.name == "__init__"):
                    out[f"{node.name}.{m.name}"] = _params(m)
        elif isinstance(node, ast.ImportFrom) and root == PORT \
                and node.module and node.module.split(".")[0] == root.name:
            for alias in node.names:
                imported[alias.asname or alias.name] = (node.module,
                                                        alias.name)
    for name, (module, orig) in imported.items():
        if not name.startswith("_") and name not in out:
            src = surface(_module_path(root, module))
            if orig in src:
                out[name] = src[orig]
    # a **kwargs handed on to a function of this module counts as that
    # function's parameters
    for name, node in defs.items():
        for target in _forwards(node) if name in out else ():
            if out.get(target) is not None:
                out[name] = out[name] + [p for p in out[target]
                                         if p not in out[name]]
    return out


def modules() -> list:
    return sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


def missing(module: str, port: dict) -> list:
    """Entry keys of what the JAX module has and the port's surface
    `port` lacks, before the two tables excuse any."""
    out = []
    for name, params in surface(JAX / module).items():
        cls = name.split(".")[0]
        if cls != name and f"{module}::{cls}" in TPU_ONLY:
            continue            # a TPU-only class excuses its methods
        if name not in port:
            out.append(f"{module}::{name}")
        elif params is not None:
            have = port[name] or []
            out += [f"{module}::{name}({p})" for p in params
                    if not p.startswith("_") and p not in have]
    return out


def problems(module: str, port: dict) -> list:
    """What fails the module: a gap that neither table excuses, or a
    renamed function that the port lacks or whose parameters differ."""
    out = [k for k in missing(module, port)
           if k not in TPU_ONLY and k not in RENAMED]
    jax = surface(JAX / module)
    for key, (name, _test) in RENAMED.items():
        if key.startswith(module + "::"):
            want = jax.get(key.split("::")[1])
            if port.get(name) != want:
                out.append(f"{key} -> {name}: {want} against "
                           f"{port.get(name)}")
    return out


def flags(text: str) -> list:
    out = []
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute) and node.func.attr == "add_argument":
            out += [a.value for a in node.args if isinstance(a, ast.Constant)
                    and isinstance(a.value, str) and a.value.startswith("-")]
    return out


def tool_pairs() -> list:
    """(repository tool, its counterpart in the port) for every Python
    tool of `tools/` and `bench.py`."""
    pairs = [(ROOT / "bench.py", PORT / "bench.py")]
    for p in sorted((ROOT / "tools").glob("*.py")):
        pairs.append((p, PORT / "tools" / (TOOL_NAMES.get(p.stem, p.stem)
                                           + ".py")))
    return pairs


def missing_flags(src: Path, port_text: str) -> list:
    have = set(flags(port_text))
    return [f"{src.relative_to(ROOT)} {f}" for f in flags(src.read_text())
            if f not in have]


def gaps() -> list:
    """Every entry the port lacks, before the two tables excuse any."""
    out = []
    for m in modules():
        out += missing(m, surface(PORT / m))
    for src, port in tool_pairs():
        out += missing_flags(src, port.read_text())
    return out


@pytest.mark.parametrize("module", modules())
def test_module_names_and_parameters(module):
    assert (PORT / module).exists(), f"no counterpart of {module}"
    assert problems(module, surface(PORT / module)) == []


def test_tool_flags():
    lack = []
    for src, port in tool_pairs():
        assert port.exists(), f"no counterpart of {src.name}: {port}"
        lack += [k for k in missing_flags(src, port.read_text())
                 if k not in TPU_ONLY]
    assert lack == [], f"the port's tools lack {lack}"


def test_no_stale_excuse():
    """Every entry of the two tables is a gap that exists: the JAX package
    has the name and the port does not."""
    live = set(gaps())
    stale = [k for k in list(RENAMED) + list(TPU_ONLY) if k not in live]
    assert stale == [], f"stale entries: {stale}"


def test_renamed_pairs_name_a_parity_test():
    for key, (name, test) in RENAMED.items():
        path, func = test.split("::")
        tree = ast.parse((ROOT / path).read_text())
        assert any(isinstance(n, ast.FunctionDef) and n.name == func
                   for n in tree.body), f"{key}: no test {test}"


def test_tpu_only_entries_give_a_reason():
    for key, why in TPU_ONLY.items():
        assert isinstance(why, str) and len(why) > 20, key


# (port module, its source text, that text with one item taken out,
# the entries the check must then report)
REMOVALS = [
    ("app/viewer.py", ",\n                 quality: int = 85)", ")",
     ["app/viewer.py::Viewer.__init__(quality)"]),
    ("render/renderer.py", "pixels=None, use_entities: bool = True)",
     "pixels=None)", ["render/renderer.py::render_frame(use_entities)",
                      "render/renderer.py::render_frame_batch(use_entities)"]),
    ("render/lights.py", "    merge: bool = True,\n", "",
     ["render/lights.py::extract_voxel_lights(merge)"]),
    ("render/wavefront.py", "def accumulate_radiance(",
     "def _accumulate_radiance(",
     ["render/wavefront.py::accumulate_radiance"]),
    ("core/vec3.py", "def full_like(", "def _full_like(",
     ["core/vec3.py::V3.full_like"]),
    ("kernels/shade.py", "import pack_hits, unpack_hits",
     "import unpack_hits", ["kernels/shade.py::pack_hits"]),
    ("core/rng.py", "def combinef(", "def _combinef(",
     ["core/rng.py::murmur3_combinef -> combinef"]),
    ("core/morton.py", "def morton_key_3d(p,", "def _morton_key_3d(p,",
     ["core/morton.py::morton_key_3d"]),
]


@pytest.mark.parametrize("module,old,new,want", REMOVALS,
                         ids=[r[3][0].split("::")[1] for r in REMOVALS])
def test_a_removed_item_fails(module, old, new, want):
    """Taking an item out of the port's source makes its module fail: a
    parameter, a method, a function, a re-export, a renamed function, and
    through the forwarded **kwargs a parameter of render_frame_batch."""
    text = (PORT / module).read_text()
    assert text.count(old) == 1, old
    got = problems(module, surface(PORT / module, text.replace(old, new)))
    for key in want:
        assert any(g.startswith(key) for g in got), (key, got)
    assert problems(module, surface(PORT / module)) == []


def test_a_removed_flag_fails():
    src = ROOT / "tools" / "trace_tune.py"
    text = (PORT / "tools" / "trace_tune.py").read_text()
    assert text.count('"--compaction"') == 1
    got = missing_flags(src, text.replace('"--compaction"', '"--compact"'))
    assert [k for k in got if k not in TPU_ONLY] == [
        "tools/trace_tune.py --compaction"]

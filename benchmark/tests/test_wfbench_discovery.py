"""A configuration, a traffic mix, a cell and a per-layer metric are
added as files and BENCHMARK.json entries alone: the harness finds them
by name, and no existing file changes."""

import json
import os
import shutil

from benchmark.harness import spec

ROOT = spec.ROOT


def copy_tree(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return tmp_path


def add(tmp_path):
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs" / "streamed_r6_1080p4.json").read_text())
    cfg.update(name="streamed_r6_720p2", width=1280, height=720,
               num_bounces=2)
    (b / "configs" / "streamed_r6_720p2.json").write_text(json.dumps(cfg))
    shutil.copy(b / "configs" / "streamed_r6_1080p4.py",
                b / "configs" / "streamed_r6_720p2.py")
    (b / "traffic" / "spin.json").write_text(json.dumps(
        {**json.loads((b / "traffic" / "orbit.json").read_text()),
         "yaw_step": 0.05}))
    (b / "metrics" / "frame_loop.launch_gap_ms.py").write_text(
        "def read(trace):\n    return 42.0\n")
    (b / "limits" / "small.spin.json").write_text('{"off_share": 0.05}')
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({
        "name": "streamed_r6_720p2", "source": "https://example.org/x",
        "file": "benchmark/configs/streamed_r6_720p2.json", "reduced": [],
        "why": "a smaller frame"})
    bench["workloads"].append({
        "name": "small.spin", "config": "streamed_r6_720p2",
        "traffic": "spin", "chips": 1, "why": "a faster orbit"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "streamed.orbit" in m["workloads"]:
            m["workloads"].append("small.spin")
    bench["per_layer"].append({
        "name": "frame_loop.launch_gap_ms", "unit": "ms",
        "better": "lower", "source": "device_trace",
        "layer": "frame loop",
        "moves": "frame_ms", "workloads": ["small.spin"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))


def snapshot(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_cell_and_metric_added_as_files(tmp_path):
    root = copy_tree(tmp_path)
    before = snapshot(root / "benchmark")
    add(root)
    after = snapshot(root / "benchmark")
    assert all(after[k] == v for k, v in before.items())
    cell = spec.load_cell("small.spin", str(root))
    assert cell.config["width"] == 1280 and cell.traffic["yaw_step"] == 0.05
    assert cell.limits == {"off_share": 0.05}
    assert hasattr(cell.build, "build") and hasattr(cell.build, "reference")
    assert [m["name"] for m in cell.end_to_end] == [
        "frame_ms", "frame_p95_ms", "setup_s"]
    names = [m["name"] for m in cell.per_layer]
    assert names == ["frame_loop.launch_gap_ms"]
    assert spec.reader("metrics", names[0], str(root)).read(None) == 42.0
    # the existing cells are unchanged by the addition
    old = spec.load_cell("streamed.orbit", str(root))
    assert "frame_loop.launch_gap_ms" not in [m["name"]
                                              for m in old.per_layer]


def test_every_named_file_exists():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.limits, w["name"]
        for m in cell.end_to_end:
            assert spec.reader("end_to_end", m["name"]).read
        for m in cell.per_layer:
            assert spec.reader("metrics", m["name"]).read
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}

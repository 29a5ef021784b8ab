"""The port's app driver and live viewer (`wavefront_tpu_torch.app`)
against the JAX package's (tests/test_app.py).

The driver runs headless and rendering on the CPU (`--device cpu`); with
`--accumulate --hold` its last image is held to the JAX app's within max
|diff| 1e-3 and RMS 1e-5 (the render tolerance of
tests/test_torch_render.py).  Both worlds are captured as
tests/test_app.py captures one, and their chunk managers made
synchronous, so both render the same window on every frame.  The viewer
serves its page, a JPEG frame at `quality` whose bytes equal the JAX
viewer's for the same float frame, its stats and the input channel;
screenshots stay PNG; window events orbit and zoom the camera.
"""

import io
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

import wavefront_tpu.app.main as jax_app
from wavefront_tpu.app.viewer import Viewer as JaxViewer
import wavefront_tpu_torch.app.main as port_app
from wavefront_tpu_torch.app.viewer import Viewer
from wavefront_tpu_torch.core.config import RenderSettings, WorldSettings
from wavefront_tpu_torch.render.screenshot import (
    png_bytes,
    read_png,
    to_srgb_bytes,
)
from wavefront_tpu_torch.world.blocks import BlockRegistry
from wavefront_tpu_torch.world.game_world import GameWorld
from wavefront_tpu_torch.world.input import Event

ASSETS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets")


def run_captured(app, argv, monkeypatch):
    """`app.main(argv)` with its world captured and its chunks generated
    on the frame thread; returns the world."""
    held = {}
    build = app.build_world

    def capture(args):
        world = build(args)
        world.managers[0].synchronous = True
        held["world"] = world
        return world

    monkeypatch.setattr(app, "build_world", capture)
    app.main(argv)
    return held["world"]


def test_app_runs_headless_frames(capsys):
    port_app.main(["--width", "16", "--height", "16", "--bounces", "1",
                   "--max-steps", "16", "--frames", "3",
                   "--window-chunks", "0", "--nee-type", "0", "--headless",
                   "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "done: 3 frames"
    assert all(line.startswith("fps: ") for line in out[:-1])


def test_app_renders_and_screenshots(tmp_path, monkeypatch):
    """The scripted fly-through renders every frame and saves the
    screenshots asked for, as PNGs of the frame's size."""
    monkeypatch.chdir(tmp_path)
    world = run_captured(port_app, [
        "--width", "16", "--height", "12", "--bounces", "1",
        "--max-steps", "16", "--frames", "4", "--window-chunks", "0",
        "--screenshot-every", "2", "--device", "cpu", "--assets", ASSETS],
        monkeypatch)
    assert world.frame_count == 4
    assert world.last_image.shape == (12, 16, 3)
    assert np.all(np.isfinite(world.last_image))
    shots = sorted(os.listdir(tmp_path / "screenshots"))
    assert shots == ["0.png", "1.png"]
    with open(tmp_path / "screenshots" / "1.png", "rb") as f:
        assert read_png(f.read()).shape == (12, 16, 3)


def test_app_accumulates_as_the_jax_app(monkeypatch):
    argv = ["--width", "16", "--height", "16", "--bounces", "1",
            "--max-steps", "24", "--frames", "3", "--window-chunks", "0",
            "--accumulate", "--hold", "--assets", ASSETS]
    port = run_captured(port_app, argv + ["--device", "cpu"], monkeypatch)
    jax = run_captured(jax_app, argv, monkeypatch)
    got, want = port.last_image, np.asarray(jax.last_image)
    assert got.shape == want.shape == (16, 16, 3)
    assert np.all(np.isfinite(got)) and got.mean() > 1e-3
    d = np.abs(got - want)
    assert d.max() < 1e-3, d.max()
    assert np.sqrt((d ** 2).mean()) < 1e-5
    assert port.renderer.settings.cache_primary


def test_app_needs_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="--device cpu"):
        port_app.main(["--frames", "1", "--headless"])


def _jpeg(rgb, quality):
    buf = io.BytesIO()
    Image.fromarray(rgb, "RGB").save(buf, "JPEG", quality=quality)
    return buf.getvalue()


def test_viewer_encodes_each_frame_once(monkeypatch):
    """Every GET of one published frame is served the same bytes, encoded
    once; the next frame is encoded anew."""
    import wavefront_tpu_torch.app.viewer as viewer_mod

    calls = []

    def counted(img):
        calls.append(img.shape)
        return to_srgb_bytes(img)

    monkeypatch.setattr(viewer_mod, "to_srgb_bytes", counted)
    v = Viewer(port=0)
    try:
        base = f"http://127.0.0.1:{v.port}"
        imgs = [np.linspace(a, 1.0, 8 * 6 * 3, dtype=np.float32).reshape(
            6, 8, 3) for a in (0.0, 0.5)]
        v.publish(imgs[0])
        got = [urllib.request.urlopen(base + "/frame").read()
               for _ in range(3)]
        assert got[0] == got[1] == got[2] and len(calls) == 1
        v.publish(imgs[1])
        assert (urllib.request.urlopen(base + "/frame").read()
                == _jpeg(to_srgb_bytes(imgs[1]), 85))
        assert len(calls) == 2
    finally:
        v.close()


@pytest.mark.parametrize("quality", [85, 50])
def test_viewer_jpeg_equals_the_jax_viewers(quality):
    """One float frame through both viewers' `_encode` at `quality`: the
    same JPEG bytes (one PIL in one process)."""
    img = np.random.default_rng(quality).random((32, 32, 3),
                                                dtype=np.float32) * 1.2
    img[0, :4] = [-0.1, 0.5, 2.0]
    port, ref = Viewer(port=0, quality=quality), JaxViewer(
        port=0, quality=quality)
    try:
        assert port._encode() is None
        port.publish(img)
        ref.publish(img)
        got = port._encode()
        assert got[:2] == b"\xff\xd8" and got == ref._encode()
    finally:
        port.close()
        ref.close()


@pytest.mark.parametrize("level", [1, 6, 9])
def test_png_levels_decode_to_the_image(level):
    rgb = to_srgb_bytes(np.random.default_rng(level).random(
        (17, 23, 3), dtype=np.float32))
    np.testing.assert_array_equal(read_png(png_bytes(rgb, level=level)), rgb)


def test_viewer_routes_and_input_channel():
    """GET / and /frame (a JPEG of the published frame), /stats, a 404,
    and POST /input -> drain_events as world.input Event records."""
    v = Viewer(port=0)
    try:
        base = f"http://127.0.0.1:{v.port}"
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/frame")
        assert e.value.code == 503
        img = np.linspace(-0.2, 1.3, 8 * 6 * 3, dtype=np.float32).reshape(
            6, 8, 3)
        v.publish(img)
        page = urllib.request.urlopen(base + "/").read()
        assert b"/input" in page and b"mousedown" in page
        r = urllib.request.urlopen(base + "/frame")
        assert r.headers["Content-Type"] == "image/jpeg"
        body = r.read()
        assert body == v._encode() == _jpeg(to_srgb_bytes(img), 85)
        decoded = np.asarray(Image.open(io.BytesIO(body)).convert("RGB"))
        assert decoded.shape == (6, 8, 3)
        stats = json.loads(urllib.request.urlopen(base + "/stats").read())
        assert stats["frame"] == 1
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/nothing")
        assert e.value.code == 404
        batch = [
            {"kind": "key_down", "key": "w"},
            {"kind": "mouse_down", "button": "middle"},
            {"kind": "mouse_move", "x": 12.5, "y": 7.0},
            {"kind": "wheel", "dy": 1.0},
            {"kind": "key_up", "key": "w"},
        ]
        req = urllib.request.Request(base + "/input",
                                     data=json.dumps(batch).encode(),
                                     method="POST")
        assert urllib.request.urlopen(req).status == 204
        evs = v.drain_events()
        assert [e.kind for e in evs] == [
            "key_down", "mouse_down", "mouse_move", "wheel", "key_up"]
        assert evs[2].x == 12.5 and evs[2].y == 7.0
        assert evs[1].button == "middle" and evs[3].dy == 1.0
        assert v.drain_events() == []
    finally:
        v.close()


def test_camera_orbit_from_window_events():
    """GameWorld routes mouse events to the interactive camera: middle-drag
    orbits (yaw/pitch), wheel zooms (reference camera.rs:144-203)."""
    world = GameWorld(
        BlockRegistry.load(ASSETS),
        settings=RenderSettings(width=32, height=32, num_bounces=1),
        world_settings=WorldSettings(), window_chunks=0, headless=True,
        device="cpu")
    cam = world.camera
    yaw0, pitch0, off0 = cam.yaw, cam.pitch, cam.offset
    world.handle_window_event(Event("mouse_move", x=16.0, y=16.0))
    world.step()
    assert cam.yaw == yaw0 and cam.pitch == pitch0
    world.handle_window_event(Event("mouse_down", button="middle"))
    world.handle_window_event(Event("mouse_move", x=24.0, y=12.0))
    world.step()
    assert cam.yaw != yaw0 and cam.pitch != pitch0
    world.handle_window_event(Event("mouse_up", button="middle"))
    world.handle_window_event(Event("wheel", dy=2.0))
    world.step()
    assert cam.offset == off0 - 2.0

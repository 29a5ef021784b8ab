"""Live viewer: stream rendered frames to a browser over HTTP.

The reference presents through a winit window + Vulkan swapchain
(main.rs:796-804, interactive_rendering.rs:1636-1646).  A TPU host has no
display stack, so the interactive story here is a streamed viewer: a tiny
threaded HTTP server exposes

    /          a page showing the live stream + fps overlay
    /stream    multipart/x-mixed-replace stream of PNG frames
    /frame     single PNG snapshot
    /stats     JSON {frame, fps}

The app driver pushes each rendered frame with `viewer.publish(img)`;
a frame is encoded lazily, once, by the first request that wants it, and
its bytes are served to every client, so an unwatched run pays nothing
beyond a numpy copy.

The channel is TWO-WAY (the reference's interactive loop is mouse-orbit +
WASD + click-to-edit, main.rs:871-883, handle_user_input.rs:57-135,
ego_controls_manager.rs:250-296): the page captures keyboard/mouse events
and POSTs them to /input as JSON; the frame loop drains them with
`viewer.drain_events()` into `GameWorld.handle_window_event`, feeding the
same `UserInputState` the synthetic-event tests exercise.

The counterpart of `wavefront_tpu.app.viewer`, with the same page,
routes and input batch.  Frames are PNG (`render/screenshot.py::
png_bytes`, zlib at level 1, the fastest) where the JAX viewer sends
JPEG through PIL, so a frame needs no imaging package; a browser shows
either.

Run:  python -m wavefront_tpu_torch.app.main --frames 100000 --serve 8787 --interactive
then open http://localhost:8787/ and fly: middle-drag orbits, wheel zooms,
WASD/space/shift moves the ego, left/right click breaks/places blocks,
Tab toggles the body mode, N/B/O/digits work as in the reference.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from wavefront_tpu_torch.render.screenshot import png_bytes, to_srgb_bytes

_PAGE = b"""<!doctype html>
<html><head><title>wavefront-tpu live</title><style>
body { background:#111; color:#ddd; font-family:monospace; text-align:center }
img { image-rendering:pixelated; width:70vmin; height:auto;
      border:1px solid #333; margin-top:2em; outline:none; cursor:crosshair }
</style></head><body>
<h3>wavefront-tpu live</h3>
<img id="v" src="/stream" tabindex="0" draggable="false">
<p id="s"></p>
<p>middle-drag orbit &middot; wheel zoom &middot; WASD/space/shift move
&middot; L/R click break/place &middot; Tab body &middot; 1-7 block
&middot; N nee &middot; B debug &middot; O sort</p>
<script>
const v = document.getElementById('v');
let q = [];
let flushing = false;
async function flush() {
  if (flushing || q.length === 0) return;
  flushing = true;
  const batch = q; q = [];
  try {
    await fetch('/input', {method: 'POST', body: JSON.stringify(batch)});
  } catch (e) {}
  flushing = false;
  if (q.length) flush();
}
setInterval(flush, 16);
function push(ev) { q.push(ev); if (q.length > 64) flush(); }
const KEYS = {KeyW:'w', KeyA:'a', KeyS:'s', KeyD:'d', Space:'space',
  ShiftLeft:'shift', ShiftRight:'shift', Tab:'tab', KeyN:'n', KeyB:'b',
  KeyO:'o', PrintScreen:'print_screen', KeyP:'print_screen',
  Digit1:'1', Digit2:'2', Digit3:'3', Digit4:'4', Digit5:'5',
  Digit6:'6', Digit7:'7', Digit8:'8', Digit9:'9'};
function imgXY(e) {
  const r = v.getBoundingClientRect();
  return [(e.clientX - r.left) / r.width * v.naturalWidth,
          (e.clientY - r.top) / r.height * v.naturalHeight];
}
const BTN = {0:'left', 1:'middle', 2:'right'};
window.addEventListener('keydown', e => {
  const k = KEYS[e.code];
  if (k) { e.preventDefault();
           if (!e.repeat) push({kind:'key_down', key:k}); }
});
window.addEventListener('keyup', e => {
  const k = KEYS[e.code];
  if (k) { e.preventDefault(); push({kind:'key_up', key:k}); }
});
v.addEventListener('mousemove', e => {
  const [x, y] = imgXY(e);
  push({kind:'mouse_move', x:x, y:y});
});
v.addEventListener('mousedown', e => {
  e.preventDefault(); v.focus();
  push({kind:'mouse_down', button:BTN[e.button]});
});
v.addEventListener('mouseup', e => {
  e.preventDefault(); push({kind:'mouse_up', button:BTN[e.button]});
});
v.addEventListener('contextmenu', e => e.preventDefault());
v.addEventListener('wheel', e => {
  e.preventDefault();
  push({kind:'wheel', dy: e.deltaY > 0 ? -1.0 : 1.0});
}, {passive:false});
setInterval(async () => {
  const r = await fetch('/stats'); const j = await r.json();
  document.getElementById('s').textContent =
    `frame ${j.frame}  ${j.fps.toFixed(1)} fps`;
}, 1000);
</script></body></html>"""


class Viewer:
    """Thread-safe latest-frame store + HTTP server."""

    def __init__(self, port: int = 8787, host: str = "127.0.0.1"):
        self._lock = threading.Condition()
        self._frame: np.ndarray | None = None
        self._seq = 0
        self._fps = 0.0
        self._last_pub = None
        self._events: list = []          # pending input events (guarded)
        # (seq, PNG bytes) of the last frame encoded, and the lock that
        # lets one request encode it while the others wait for its bytes
        self._png: tuple = (-1, b"")
        self._encode_lock = threading.Lock()

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            # TCP_NODELAY: a frame's last segment goes out at once instead
            # of waiting, behind the headers' small segment, for the
            # client's delayed ACK (up to 200 ms a request)
            disable_nagle_algorithm = True

            def log_message(self, *a):  # quiet
                pass

            def do_POST(self):
                # /input: JSON list of {kind, key?, x?, y?, button?, dy?}
                # records (the page's keyboard/mouse capture) queued for
                # the frame loop's drain_events()
                try:
                    if self.path != "/input":
                        self.send_response(404)
                        self.end_headers()
                        return
                    length = int(self.headers.get("Content-Length", 0))
                    body = self.rfile.read(length) if length else b"[]"
                    batch = json.loads(body)
                    if isinstance(batch, dict):
                        batch = [batch]
                    from wavefront_tpu_torch.world.input import Event

                    events = [
                        Event(
                            kind=str(e.get("kind", "")),
                            key=e.get("key"),
                            x=float(e.get("x", 0.0)),
                            y=float(e.get("y", 0.0)),
                            button=e.get("button"),
                            dy=float(e.get("dy", 0.0)),
                        )
                        for e in batch
                        if isinstance(e, dict)
                    ]
                    with viewer._lock:
                        viewer._events.extend(events)
                        # a stalled frame loop must not grow unbounded
                        del viewer._events[:-1024]
                    self.send_response(204)
                    self.end_headers()
                except (BrokenPipeError, ConnectionResetError):
                    pass
                except Exception:
                    self.send_response(400)
                    self.end_headers()

            def do_GET(self):
                try:
                    if self.path == "/":
                        self.send_response(200)
                        self.send_header("Content-Type", "text/html")
                        self.end_headers()
                        self.wfile.write(_PAGE)
                    elif self.path == "/frame":
                        png = viewer._encode()
                        if png is None:
                            self.send_response(503)
                            self.end_headers()
                            return
                        self.send_response(200)
                        self.send_header("Content-Type", "image/png")
                        self.end_headers()
                        self.wfile.write(png)
                    elif self.path == "/stats":
                        self.send_response(200)
                        self.send_header("Content-Type", "application/json")
                        self.end_headers()
                        self.wfile.write(json.dumps(
                            {"frame": viewer._seq, "fps": viewer._fps}
                        ).encode())
                    elif self.path == "/stream":
                        self.send_response(200)
                        self.send_header(
                            "Content-Type",
                            "multipart/x-mixed-replace; boundary=F",
                        )
                        self.end_headers()
                        seen = -1
                        while True:
                            with viewer._lock:
                                viewer._lock.wait_for(
                                    lambda: viewer._seq != seen, timeout=5.0
                                )
                                seen = viewer._seq
                            png = viewer._encode()
                            if png is None:
                                continue
                            self.wfile.write(
                                b"--F\r\nContent-Type: image/png\r\n"
                                + f"Content-Length: {len(png)}\r\n\r\n".encode()
                            )
                            self.wfile.write(png)
                            self.wfile.write(b"\r\n")
                    else:
                        self.send_response(404)
                        self.end_headers()
                except (BrokenPipeError, ConnectionResetError):
                    pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_port
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True
        )
        self._thread.start()

    def drain_events(self) -> list:
        """Pop all pending browser input events (wavefront_tpu_torch.world.input
        Event records, in arrival order) — called once per frame by the
        interactive loop."""
        with self._lock:
            events, self._events = self._events, []
        return events

    def publish(self, img: np.ndarray) -> None:
        """Called by the frame loop with the latest (H, W, 3) float image."""
        now = time.perf_counter()
        with self._lock:
            self._frame = np.asarray(img)
            self._seq += 1
            if self._last_pub is not None:
                dt = now - self._last_pub
                inst = 1.0 / dt if dt > 0 else 0.0
                self._fps = 0.9 * self._fps + 0.1 * inst if self._fps else inst
            self._last_pub = now
            self._lock.notify_all()

    def _encode(self):
        """The latest frame as PNG bytes, or None before the first; each
        frame is encoded once, whatever the number of clients."""
        with self._encode_lock:
            with self._lock:
                frame, seq = self._frame, self._seq
            if frame is None:
                return None
            if self._png[0] != seq:
                self._png = (seq, png_bytes(to_srgb_bytes(frame), level=1))
            return self._png[1]

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()

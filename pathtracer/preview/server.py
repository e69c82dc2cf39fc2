"""Interactive web preview.

Replaces the reference's OpenGL+GLFW+ImGui preview window (reference:
src/preview.cpp, src/main.cpp mouse/key callbacks) with a zero-dependency
HTTP preview: the renderer loop runs in the main thread while a background
HTTP server serves the progressively-converging frame and accepts camera
orbits.

Feature parity with the ImGui panel (reference: src/preview.cpp:222-252):
- traced depth, ms/frame + FPS (here: Mrays/s), triangle & BVH node counts
- camera position and theta/phi orbit controls (mouse drag on the image,
  reference: src/main.cpp:255-289)
- SampleMode combo (BSDF / DirectLight / MIS — switching resets
  accumulation, like the reference's camchanged path)
- S saves a PNG, matching the reference's save hotkey
  (reference: src/main.cpp:236-238)
"""

from __future__ import annotations

import io
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from pathtracer.utils.image_io import write_png

_PAGE = """<!DOCTYPE html>
<html><head><title>pathtracer preview</title>
<style>
 body { background:#181818; color:#ddd; font-family:monospace; margin:14px; }
 #wrap { display:flex; gap:18px; }
 img { image-rendering:pixelated; border:1px solid #444; cursor:grab; }
 table td { padding:1px 8px; }
 select,button { background:#282828; color:#ddd; border:1px solid #555; }
</style></head>
<body>
<div id="wrap">
 <img id="frame" src="/frame.png" draggable="false">
 <div>
  <h3>pathtracer</h3>
  <table id="stats"></table>
  <p>mode <select id="mode">
    <option value="0">BSDF</option><option value="1">DirectLight</option>
    <option value="2">MIS</option></select>
   <button onclick="fetch('/reset')">reset</button>
   <button onclick="fetch('/save')">save PNG</button></p>
  <p>left-drag orbit · right-drag zoom · middle-drag pan
     (reference mouse parity)</p>
 </div>
</div>
<script>
const img = document.getElementById('frame');
img.oncontextmenu = e => e.preventDefault();
let drag = null, btn = 0;
img.onmousedown = e => { drag = [e.clientX, e.clientY]; btn = e.button; };
window.onmouseup = () => { drag = null; };
window.onmousemove = e => {
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  drag = [e.clientX, e.clientY];
  if (btn === 0)      // left: orbit (reference src/main.cpp:255-261)
    fetch(`/orbit?dphi=${dx*0.4}&dtheta=${-dy*0.4}`);
  else if (btn === 2) // right: dolly (reference src/main.cpp:263-266)
    fetch(`/zoom?dy=${dy/img.height}`);
  else if (btn === 1) // middle: pan (reference src/main.cpp:268-281)
    fetch(`/pan?dx=${dx}&dy=${dy}`);
};
document.getElementById('mode').onchange = e => fetch('/mode?m='+e.target.value);
setInterval(() => { img.src = '/frame.png?' + Date.now(); }, 900);
setInterval(async () => {
  const s = await (await fetch('/stats.json')).json();
  document.getElementById('stats').innerHTML =
    Object.entries(s).map(([k,v]) => `<tr><td>${k}</td><td>${v}</td></tr>`).join('');
}, 900);
</script></body></html>"""


class PreviewState:
    """Shared state between the render loop and HTTP threads."""

    def __init__(self, renderer):
        self.renderer = renderer
        self.lock = threading.Lock()
        self.pending_orbit = None   # (dtheta, dphi)
        self.pending_zoom = None    # dy fraction (right drag)
        self.pending_pan = None     # (dx_px, dy_px) (middle drag)
        self.pending_mode = None
        self.pending_reset = False
        self.pending_save = False
        self.frame_png = b""
        self.stats = {}
        self.running = True
        # monotonically increments whenever accumulation restarts — an
        # EVENT the tests can wait on (sampling renderer.iteration races
        # with the render loop advancing it again)
        self.accum_resets = 0

    def snapshot(self):
        r = self.renderer
        buf = io.BytesIO()
        img = r.ldr_image()[:, ::-1]  # reference saves X-mirrored
        _write_png_bytes(buf, img)
        with self.lock:
            self.frame_png = buf.getvalue()
            self.stats = {
                "iteration": r.iteration,
                "mode": r.opts.sample_mode.name,
                "Mrays/s": round(r.stats.mrays_per_sec, 2),
                # LIVE depth reached last iteration (reference ImGui panel,
                # src/pathtrace.cu:793-796), not the static scene maximum
                "traced depth": r.traced_depth,
                "triangles": r.static.num_tris,
                "BVH nodes": r.static.num_bvh_nodes,
                "resolution": f"{r.width}x{r.height}",
                "camera": "(%.2f, %.2f, %.2f)" % tuple(r.camera.position),
                "theta/phi": "%.1f / %.1f" % (r.camera.theta, r.camera.phi),
                "resets": self.accum_resets,
            }

    def apply_pending(self):
        """Called by the render loop between iterations."""
        with self.lock:
            orbit, self.pending_orbit = self.pending_orbit, None
            zoom, self.pending_zoom = self.pending_zoom, None
            pan, self.pending_pan = self.pending_pan, None
            mode, self.pending_mode = self.pending_mode, None
            reset, self.pending_reset = self.pending_reset, False
            save, self.pending_save = self.pending_save, False
        r = self.renderer
        restarted = False
        if mode is not None and int(mode) != int(r.opts.sample_mode):
            from pathtracer.integrator.render import Renderer

            new = Renderer(r.scene, opts=r.opts.with_mode(int(mode)))
            new.camera = r.camera
            self.renderer = new
            restarted = True
        if orbit is not None:
            dtheta, dphi = orbit
            cam = self.renderer.camera
            theta = float(np.clip(cam.theta + dtheta, -89.0, 89.0))
            self.renderer.set_orbit(theta, cam.phi + dphi)
            restarted = True
        if zoom is not None:
            self.renderer.zoom(float(zoom))
            restarted = True
        if pan is not None:
            self.renderer.pan(float(pan[0]), float(pan[1]))
            restarted = True
        if reset:
            self.renderer.reset()
            restarted = True
        if save:
            self.renderer.save_png(f"{self.renderer.static.image_name}.preview.png")
        if restarted:
            with self.lock:
                self.accum_resets += 1


def _write_png_bytes(buf, img):
    import struct
    import zlib

    arr = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    h, w, _ = arr.shape
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))

    def chunk(tag, payload):
        out = struct.pack(">I", len(payload)) + tag + payload
        return out + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)

    buf.write(
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw, 3))
        + chunk(b"IEND", b"")
    )


def make_handler(state: PreviewState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _send(self, code, ctype, body):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            q = parse_qs(url.query)
            if url.path == "/":
                self._send(200, "text/html", _PAGE.encode())
            elif url.path == "/frame.png":
                with state.lock:
                    png = state.frame_png
                self._send(200, "image/png", png or b"")
            elif url.path == "/stats.json":
                with state.lock:
                    body = json.dumps(state.stats).encode()
                self._send(200, "application/json", body)
            elif url.path == "/orbit":
                with state.lock:
                    dt = float(q.get("dtheta", ["0"])[0])
                    dp = float(q.get("dphi", ["0"])[0])
                    if state.pending_orbit:
                        dt += state.pending_orbit[0]
                        dp += state.pending_orbit[1]
                    state.pending_orbit = (dt, dp)
                self._send(200, "text/plain", b"ok")
            elif url.path == "/zoom":
                with state.lock:
                    dy = float(q.get("dy", ["0"])[0])
                    if state.pending_zoom:
                        dy += state.pending_zoom
                    state.pending_zoom = dy
                self._send(200, "text/plain", b"ok")
            elif url.path == "/pan":
                with state.lock:
                    dx = float(q.get("dx", ["0"])[0])
                    dy = float(q.get("dy", ["0"])[0])
                    if state.pending_pan:
                        dx += state.pending_pan[0]
                        dy += state.pending_pan[1]
                    state.pending_pan = (dx, dy)
                self._send(200, "text/plain", b"ok")
            elif url.path == "/mode":
                with state.lock:
                    state.pending_mode = int(q.get("m", ["0"])[0])
                self._send(200, "text/plain", b"ok")
            elif url.path == "/reset":
                with state.lock:
                    state.pending_reset = True
                self._send(200, "text/plain", b"ok")
            elif url.path == "/save":
                with state.lock:
                    state.pending_save = True
                self._send(200, "text/plain", b"ok")
            else:
                self._send(404, "text/plain", b"not found")

    return Handler


def run_preview(renderer, host="127.0.0.1", port=8000, chunk=4, max_iterations=None):
    """Blocking preview loop: render `chunk` spp, publish frame, repeat."""
    state = PreviewState(renderer)
    server = ThreadingHTTPServer((host, port), make_handler(state))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    print(f"preview at http://{host}:{server.server_address[1]}/")
    try:
        while state.running:
            state.apply_pending()
            r = state.renderer
            limit = max_iterations if max_iterations is not None else r.static.iterations
            if r.iteration < limit:
                r.step(chunk)
            else:
                time.sleep(0.2)
            state.snapshot()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
    return state


def start_preview_thread(renderer, host="127.0.0.1", port=0, chunk=2):
    """Non-blocking variant for tests: returns (state, server, loop_thread)."""
    state = PreviewState(renderer)
    server = ThreadingHTTPServer((host, port), make_handler(state))
    srv_thread = threading.Thread(target=server.serve_forever, daemon=True)
    srv_thread.start()

    def loop():
        while state.running:
            state.apply_pending()
            state.renderer.step(chunk)
            state.snapshot()

    loop_thread = threading.Thread(target=loop, daemon=True)
    loop_thread.start()
    return state, server, loop_thread

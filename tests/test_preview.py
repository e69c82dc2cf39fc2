"""Preview server tests: drive the HTTP surface like a browser would
(frame fetch, stats, orbit drag, mode switch)."""

import json
import textwrap
import time
import urllib.request

import numpy as np
import pytest

from pathtracer.integrator.render import Renderer
from pathtracer.preview.server import start_preview_thread
from pathtracer.utils.config import RenderOptions, SampleMode

SCENE = """
MATERIAL light
TYPE\tLight
ALBEDO      5 5 5
METALLIC    0
ROUGHNESS   0
IOR         0

MATERIAL white
TYPE\tLambertian
ALBEDO      .8 .8 .8
METALLIC    0
ROUGHNESS   0
IOR         0

CAMERA
RES         32 32
FOVY        45
ITERATIONS  100000
DEPTH       3
FILE        preview
EYE         0 1 5
LOOKAT      0 1 0
UP          0 1 0

OBJECT floor
cube
material white
TRANS       0 0 0
ROTAT       0 0 0
SCALE       8 .01 8

OBJECT lamp
sphere
material light
TRANS       0 3 0
ROTAT       0 0 0
SCALE       1 1 1
"""


@pytest.fixture()
def preview(tmp_path):
    scene = tmp_path / "p.txt"
    scene.write_text(textwrap.dedent(SCENE))
    r = Renderer(scene, opts=RenderOptions(sample_mode=SampleMode.MIS))
    state, server, thread = start_preview_thread(r, port=0, chunk=1)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    yield state, base
    state.running = False
    server.shutdown()


def get(base, path, timeout=30):
    return urllib.request.urlopen(base + path, timeout=timeout)


class TestPreviewServer:
    def test_page_and_frame(self, preview):
        state, base = preview
        page = get(base, "/").read()
        assert b"pathtracer" in page
        deadline = time.time() + 60
        png = b""
        while time.time() < deadline:
            png = get(base, "/frame.png").read()
            if png.startswith(b"\x89PNG"):
                break
            time.sleep(0.5)
        assert png.startswith(b"\x89PNG")

    @pytest.mark.slow
    def test_stats_progress(self, preview):
        state, base = preview
        deadline = time.time() + 60
        it = 0
        while time.time() < deadline:
            stats = json.loads(get(base, "/stats.json").read() or b"{}")
            it = stats.get("iteration", 0)
            if it >= 2:
                break
            time.sleep(0.5)
        assert it >= 2
        assert stats["mode"] == "MIS"
        assert stats["resolution"] == "32x32"

    @pytest.mark.slow
    def test_orbit_resets_accumulation(self, preview):
        state, base = preview
        resets0 = state.accum_resets
        get(base, "/orbit?dtheta=10&dphi=-15").read()
        # wait on EVENTS (pose + reset counter), not on sampling the
        # iteration count — iteration advances again immediately after the
        # reset, so a sampled dip is a race
        deadline = time.time() + 60
        theta_ok = False
        while time.time() < deadline:
            r = state.renderer
            if abs(r.camera.theta - 10.0) < 1e-3:
                theta_ok = True
            if theta_ok and state.accum_resets > resets0:
                break
            time.sleep(0.05)
        assert theta_ok, "orbit should change theta"
        assert state.accum_resets > resets0, "orbit should reset accumulation"

    @pytest.mark.slow
    def test_zoom_and_pan(self, preview):
        state, base = preview
        pos0 = np.array(state.renderer.camera.position)
        view0 = np.array(state.renderer.camera.view)
        resets0 = state.accum_resets
        get(base, "/zoom?dy=0.5").read()
        deadline = time.time() + 60
        while time.time() < deadline and state.accum_resets == resets0:
            time.sleep(0.05)
        pos1 = np.array(state.renderer.camera.position)
        # dolly: moved opposite the view by 0.5 (reference zoom magnitude)
        np.testing.assert_allclose(pos1, pos0 - 0.5 * view0, atol=1e-5)

        resets1 = state.accum_resets
        get(base, "/pan?dx=100&dy=0").read()
        deadline = time.time() + 60
        while time.time() < deadline and state.accum_resets == resets1:
            time.sleep(0.05)
        pos2 = np.array(state.renderer.camera.position)
        # pan: -dx * ground-projected right * 0.01 (reference main.cpp:268-281)
        right = np.array(state.renderer.camera.right)
        right[1] = 0.0
        right /= np.linalg.norm(right)
        np.testing.assert_allclose(pos2, pos1 - 1.0 * right, atol=1e-5)

    @pytest.mark.slow
    def test_live_traced_depth(self, preview):
        state, base = preview
        deadline = time.time() + 60
        depth = 0
        while time.time() < deadline:
            stats = json.loads(get(base, "/stats.json").read() or b"{}")
            depth = stats.get("traced depth", 0)
            if depth > 0:
                break
            time.sleep(0.5)
        assert 1 <= depth <= state.renderer.static.trace_depth + 1

    @pytest.mark.slow
    def test_mode_switch(self, preview):
        state, base = preview
        get(base, "/mode?m=0").read()
        deadline = time.time() + 60
        while time.time() < deadline:
            stats = json.loads(get(base, "/stats.json").read() or b"{}")
            if stats.get("mode") == "BSDF":
                break
            time.sleep(0.5)
        assert stats["mode"] == "BSDF"

"""CLI surface tests (the reference's main() equivalent)."""

import json
import sys

import numpy as np
import pytest

from pathtracer import cli
from pathtracer.utils.image_io import read_png


class TestCli:
    def test_info(self, scenes_dir, capsys):
        rc = cli.main(["info", str(scenes_dir / "cornell.txt")])
        assert rc == 0
        out = json.loads(capsys.readouterr().out)
        assert out["geoms"] == 8 and out["lights"] == 1
        assert out["resolution"] == [800, 800]

    def test_render_roundtrip(self, scenes_dir, tmp_path, capsys):
        out = tmp_path / "r.png"
        rc = cli.main(
            [
                "render", str(scenes_dir / "cornell.txt"),
                "--cpu", "--res", "32x32", "--spp", "2", "--mode", "mis",
                "-o", str(out),
            ]
        )
        assert rc == 0
        img = read_png(out)
        assert img.shape == (32, 32, 3)
        assert img.max() > 0

    def test_bench_json(self, scenes_dir, tmp_path, capsys):
        rc = cli.main(
            [
                "bench", str(scenes_dir / "cornell.txt"),
                "--cpu", "--res", "32x32", "--spp", "2",
            ]
        )
        assert rc == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["rays_traced"] > 0 and out["mrays_per_sec"] > 0

    def test_missing_scene_exit_code(self, capsys):
        rc = cli.main(["render", "/nonexistent.txt", "--cpu"])
        assert rc == 2

    def test_bad_res(self):
        with pytest.raises(SystemExit):
            cli.main(["render", "x.txt", "--cpu", "--res", "64"])


class TestCheckpointGuards:
    def test_swizzle_mismatch_rejected(self, tmp_path):
        import textwrap
        from pathtracer.integrator.render import Renderer
        from pathtracer.utils.config import RenderOptions, SampleMode
        from tests.test_traverse import tri_soup_scene

        scene = tri_soup_scene(tmp_path, n=600)  # >=512 tris → swizzle active
        r = Renderer(scene, opts=RenderOptions(sample_mode=SampleMode.BSDF))
        assert r.pixel_order is not None
        r.step(1)
        ck = tmp_path / "ck.npz"
        r.save_checkpoint(ck)
        r2 = Renderer(
            scene,
            opts=RenderOptions(sample_mode=SampleMode.BSDF, swizzle=False),
        )
        with pytest.raises(ValueError, match="pixel-order"):
            r2.load_checkpoint(ck)

    def test_checkpoint_roundtrip_with_swizzle(self, tmp_path):
        import numpy as np
        from pathtracer.integrator.render import Renderer
        from pathtracer.utils.config import RenderOptions, SampleMode
        from tests.test_traverse import tri_soup_scene

        scene = tri_soup_scene(tmp_path, n=600)
        r = Renderer(scene, opts=RenderOptions(sample_mode=SampleMode.BSDF))
        r.step(3)
        ck = tmp_path / "ck.npz"
        r.save_checkpoint(ck)
        r.step(2)
        a = r.ldr_image()
        r2 = Renderer(scene, opts=RenderOptions(sample_mode=SampleMode.BSDF))
        r2.load_checkpoint(ck)
        r2.step(2)
        np.testing.assert_array_equal(a, r2.ldr_image())

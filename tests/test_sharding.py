"""Multi-device sharding tests on the 8-device virtual CPU mesh.

Validates the scale-out design (SURVEY.md §2 parallelism table): the
pixel-sharded render must be bitwise identical to a single-device render of
the same shard shape (position-keyed RNG), and statistically identical to
the full-frame render.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pathtracer.integrator.wavefront import CameraArrays, make_render_iteration
from pathtracer.parallel import sharding as sh
from pathtracer.scene.camera import derive_camera
from pathtracer.scene.flatscene import build_flat_scene
from pathtracer.scene.parser import load_scene
from pathtracer.utils import rng
from pathtracer.utils.config import RenderOptions, SampleMode


@pytest.fixture(scope="module")
def setup(scenes_dir):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    scene = load_scene(scenes_dir / "cornell.txt")
    scene.camera.resolution = (64, 64)
    flat, static = build_flat_scene(scene)
    opts = RenderOptions(sample_mode=SampleMode.MIS)
    p, v, u, r, pl = derive_camera(scene.camera).as_arrays()
    cam = CameraArrays(
        jnp.asarray(p), jnp.asarray(v), jnp.asarray(u), jnp.asarray(r), jnp.asarray(pl)
    )
    return flat, static, opts, cam


class TestPixelSharding:
    def test_shard_bitwise_matches_same_shape_single(self, setup):
        flat, static, opts, cam = setup
        key = rng.base_key(0)
        mesh = sh.make_mesh(8)
        step, _, ph = sh.make_sharded_iteration(static, opts, 64, 64, mesh)
        img = sh.zeros_image(64, 64, mesh)
        img, rays, _ = step(flat, cam, img, jnp.int32(1), key)
        sharded = sh.fetch_image(img, 64, 64)
        assert int(rays) > 0

        local = jax.jit(make_render_iteration(static, opts, 64, 64, local_rows=8))
        for d in (0, 3, 7):
            img1 = jnp.zeros((512, 3), jnp.float32)
            img1, _, _ = local(flat, cam, img1, jnp.int32(1), key, jnp.int32(d * 512))
            np.testing.assert_array_equal(
                sharded[d * 8 : (d + 1) * 8], np.asarray(img1).reshape(8, 64, 3)
            )

    def test_statistical_agreement_with_full_frame(self, tmp_path):
        # firefly-free scene (no delta lobes) so image means are
        # well-behaved: a lambertian box with a sphere light
        import textwrap

        scene_file = tmp_path / "box.txt"
        scene_file.write_text(
            textwrap.dedent(
                """
                MATERIAL light
                TYPE\tLight
                ALBEDO      6 6 6
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
                RES         64 64
                FOVY        45
                ITERATIONS  10
                DEPTH       4
                FILE        box
                EYE         0 2.5 6
                LOOKAT      0 2.5 0
                UP          0 1 0

                OBJECT floor
                cube
                material white
                TRANS       0 0 0
                ROTAT       0 0 0
                SCALE       10 .01 10

                OBJECT lamp
                sphere
                material light
                TRANS       0 4.5 0
                ROTAT       0 0 0
                SCALE       1 1 1
                """
            )
        )
        scene = load_scene(scene_file)
        flat, static = build_flat_scene(scene)
        opts = RenderOptions(sample_mode=SampleMode.MIS)
        p, v, u, r, pl = derive_camera(scene.camera).as_arrays()
        cam = CameraArrays(*[jnp.asarray(x) for x in (p, v, u, r, pl)])
        key = rng.base_key(0)
        mesh = sh.make_mesh(8)
        step, _, _ = sh.make_sharded_iteration(static, opts, 64, 64, mesh)
        img = sh.zeros_image(64, 64, mesh)
        full = jax.jit(make_render_iteration(static, opts, 64, 64))
        img1 = jnp.zeros((64 * 64, 3), jnp.float32)
        iters = 32
        for it in range(1, iters + 1):
            img, _, _ = step(flat, cam, img, jnp.int32(it), key)
            img1, _, _ = full(flat, cam, img1, jnp.int32(it), key)
        a = sh.fetch_image(img, 64, 64) / iters
        b = np.asarray(img1).reshape(64, 64, 3) / iters
        # identical RNG streams; residual differences only from
        # shape-dependent XLA float codegen flipping chaotic per-path
        # decisions, unbiased on both sides
        assert abs(a.mean() - b.mean()) / b.mean() < 0.03
        ta = np.clip(a, 0, 1) ** (1 / 2.2)
        tb = np.clip(b, 0, 1) ** (1 / 2.2)
        rmse = np.sqrt(((ta - tb) ** 2).mean())
        assert rmse < 0.05, f"rmse={rmse}"

    def test_row_padding(self):
        assert sh.padded_height(64, 8) == 64
        assert sh.padded_height(100, 8) == 104
        assert sh.padded_height(1, 8) == 8

    def test_padded_resolution_renders(self, setup):
        flat, static, opts, cam = setup
        # 100 rows over 8 devices → 104 padded; out-of-frame rows are
        # harmless extra pixels (y beyond height renders sky/walls)
        key = rng.base_key(0)
        mesh = sh.make_mesh(8)
        step, _, ph = sh.make_sharded_iteration(static, opts, 64, 100, mesh)
        assert ph == 104
        img = sh.zeros_image(64, 100, mesh)
        img, _, _ = step(flat, cam, img, jnp.int32(1), key)
        out = sh.fetch_image(img, 64, 100)
        assert out.shape == (100, 64, 3)
        assert np.isfinite(out).all()


class TestRendererDevicesSmoke:
    """Default-tier guard (ADVICE r4): the `Renderer(devices=N)` surface
    must not regress silently between rounds — 2 devices, tiny frame, one
    step, bitwise vs single-device.  The heavier 8-device/triangle/
    checkpoint variants stay in the --runslow class below."""

    def test_renderer_2dev_bitwise_matches_single(self, scenes_dir):
        if len(jax.devices()) < 2:
            pytest.skip("needs 2 virtual devices")
        from pathtracer.integrator.render import Renderer

        opts = RenderOptions(sample_mode=SampleMode.MIS)
        r2 = Renderer(str(scenes_dir / "cornell.txt"), opts=opts,
                      resolution=(32, 32), trace_depth=3, devices=2)
        r1 = Renderer(str(scenes_dir / "cornell.txt"), opts=opts,
                      resolution=(32, 32), trace_depth=3)
        r2.step(1)
        r1.step(1)
        np.testing.assert_array_equal(r2.ldr_image(), r1.ldr_image())


    def test_sharded_mesh_matches_unswizzled_single(self, scenes_dir):
        """Triangle scenes swizzle the single-device pool, which keys the
        RNG by lane; the row-sharded pool keys it by pixel.  So the sharded
        render equals the single-device render with the swizzle OFF (and
        only in distribution the swizzled one).  64x32 spans two 32x32
        swizzle blocks, so the swizzle is not the identity here."""
        if len(jax.devices()) < 2:
            pytest.skip("needs 2 virtual devices")
        from dataclasses import replace

        from pathtracer.integrator.render import Renderer

        opts = RenderOptions(sample_mode=SampleMode.MIS)
        scene = str(scenes_dir / "glassbunny.txt")
        r2 = Renderer(scene, opts=opts, resolution=(64, 32), trace_depth=2,
                      devices=2)
        r1 = Renderer(scene, opts=replace(opts, swizzle=False),
                      resolution=(64, 32), trace_depth=2)
        rz = Renderer(scene, opts=opts, resolution=(64, 32), trace_depth=2)
        assert rz.pixel_order is not None
        assert not np.array_equal(rz.pixel_order, np.arange(64 * 32))
        for r in (r2, r1, rz):
            r.step(1)
        np.testing.assert_allclose(r2.ldr_image(), r1.ldr_image(), atol=1e-5)
        assert np.abs(r2.ldr_image() - rz.ldr_image()).max() > 1e-2


@pytest.mark.slow
class TestRendererDevices:
    """The user surface: `Renderer(devices=N)` / `cli render --devices N`."""

    def test_renderer_8dev_bitwise_matches_single(self, scenes_dir):
        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        from pathtracer.integrator.render import Renderer

        opts = RenderOptions(sample_mode=SampleMode.MIS)
        r8 = Renderer(str(scenes_dir / "cornell.txt"), opts=opts,
                      resolution=(64, 64), devices=8)
        r1 = Renderer(str(scenes_dir / "cornell.txt"), opts=opts,
                      resolution=(64, 64))
        r8.step(3)
        r1.step(3)
        assert r8.traced_depth > 0
        np.testing.assert_array_equal(r8.ldr_image(), r1.ldr_image())

    def test_renderer_devices_triangle_scene(self, tmp_path):
        """Sharded + triangle mesh: the fused loop runs per shard (swizzle
        off), result pixel-identical to the swizzled single-device render."""
        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        from pathtracer.integrator.render import Renderer
        from tests.test_traverse import tri_soup_scene

        path = tri_soup_scene(tmp_path, n=64, seed=9)
        opts = RenderOptions(sample_mode=SampleMode.BSDF)
        r8 = Renderer(path, opts=opts, resolution=(32, 32), trace_depth=3,
                      devices=8)
        r1 = Renderer(path, opts=opts, resolution=(32, 32), trace_depth=3)
        r8.step(2)
        r1.step(2)
        np.testing.assert_array_equal(r8.ldr_image(), r1.ldr_image())

    def test_sharded_checkpoint_roundtrip(self, scenes_dir, tmp_path):
        if len(jax.devices()) < 8:
            pytest.skip("needs 8 virtual devices")
        from pathtracer.integrator.render import Renderer

        opts = RenderOptions(sample_mode=SampleMode.MIS)
        scene = str(scenes_dir / "cornell.txt")
        ra = Renderer(scene, opts=opts, resolution=(64, 64), devices=8)
        ra.step(2)
        ck = tmp_path / "shard.npz"
        ra.save_checkpoint(ck)
        ra.step(2)

        rb = Renderer(scene, opts=opts, resolution=(64, 64), devices=8)
        rb.load_checkpoint(ck)
        rb.step(2)
        np.testing.assert_array_equal(np.asarray(ra.img), np.asarray(rb.img))

        # device-count mismatch must refuse to load
        r1 = Renderer(scene, opts=opts, resolution=(64, 64))
        with pytest.raises(ValueError, match="device-count"):
            r1.load_checkpoint(ck)


class TestShardedKernelComposition:
    def test_sharded_interpret_kernel_matches_xla(self, tmp_path, kernel_walk):
        """Sharded render through the traversal kernel (interpret mode
        inside shard_map) must match the sharded XLA-walk render — the
        sharding and traversal layers are independent."""
        from dataclasses import replace

        from pathtracer.integrator.render import Renderer
        from tests.test_traverse import tri_soup_scene

        path = tri_soup_scene(tmp_path, n=600, seed=9)
        base = RenderOptions(sample_mode=SampleMode.MIS)
        ra = Renderer(path, opts=base,
                      resolution=(16, 8), trace_depth=2, devices=2)
        rb = Renderer(path, opts=replace(base, traversal="xla"),
                      resolution=(16, 8), trace_depth=2, devices=2)
        assert ra.traversal == "kernel" and rb.traversal == "xla"
        ra.step(1)
        rb.step(1)
        np.testing.assert_allclose(
            np.asarray(ra.img), np.asarray(rb.img), rtol=1e-5, atol=1e-6
        )

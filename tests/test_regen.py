"""Cross-iteration ray regeneration (persistent wavefront pool).

The regeneration batch must integrate EXACTLY the same (pixel, sample,
bounce, stage) sample set as the sequential renderer — the RNG packs
per-lane iteration/depth into the threefry counter, so a refilled lane
draws bit-identical streams to the iteration it replaces.  Only the
float-accumulation ORDER differs (a pixel's samples sum on the lane before
the one image add), so: nk=1 batches are BITWISE equal to one iteration,
and nk>1 batches match sequential renders to float32 reassociation
tolerance.
"""

from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pathtracer.integrator.render import Renderer, swizzle_map
from pathtracer.integrator.wavefront import (
    CameraArrays,
    make_render_iteration,
    swizzle_xy_from_lane,
)
from pathtracer.scene.camera import derive_camera
from pathtracer.scene.flatscene import build_flat_scene
from pathtracer.scene.parser import load_scene
from pathtracer.utils import rng
from pathtracer.utils.config import RenderOptions, SampleMode

from tests.test_envmap import make_env_scene
from tests.test_traverse import tri_soup_scene

CORNELL = str(Path(__file__).resolve().parent.parent / "scenes" / "cornell.txt")


def _close(a, b, rtol=2e-4, atol=2e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


class TestSwizzleInverse:
    @pytest.mark.parametrize("w,h", [(64, 64), (96, 32), (128, 96)])
    def test_arithmetic_matches_argsort_map(self, w, h):
        order = swizzle_map(w, h)  # lane -> pixel
        l = jnp.arange(w * h, dtype=jnp.int32)
        x, y = swizzle_xy_from_lane(l, w)
        np.testing.assert_array_equal(np.asarray(x), (order % w).astype(np.float32))
        np.testing.assert_array_equal(np.asarray(y), (order // w).astype(np.float32))


class TestRegenRenderer:
    def test_nk1_bitwise_matches_classic(self, scenes_dir):
        """A 1-sample batch runs the identical program shape with identical
        RNG — the image must be BITWISE equal to the classic iteration."""
        opts = RenderOptions(sample_mode=SampleMode.MIS)
        ra = Renderer(CORNELL, opts=RenderOptions(sample_mode=SampleMode.MIS,
                                                  ray_regen=4),
                      resolution=(32, 32), trace_depth=4)
        rb = Renderer(CORNELL, opts=opts, resolution=(32, 32), trace_depth=4)
        assert ra._regen == 4
        ra.step(1)  # first call = nk=1 warmup batch
        rb.step(1)
        np.testing.assert_array_equal(np.asarray(ra.img), np.asarray(rb.img))

    @pytest.mark.parametrize("mode", [SampleMode.BSDF, SampleMode.MIS])
    def test_matches_sequential_cornell(self, mode):
        opts = RenderOptions(sample_mode=mode, ray_regen=4)
        ra = Renderer(CORNELL, opts=opts, resolution=(32, 32), trace_depth=5)
        rb = Renderer(CORNELL, opts=RenderOptions(sample_mode=mode),
                      resolution=(32, 32), trace_depth=5)
        ra.step(9)  # 1 warm + batch(4) + batch(4)
        rb.step(9)
        assert ra.iteration == rb.iteration == 9
        _close(ra.img, rb.img)

    def test_partial_tail_batches(self):
        """step counts not divisible by ray_regen run a traced-smaller nk
        through the SAME executable."""
        opts = RenderOptions(sample_mode=SampleMode.MIS, ray_regen=4)
        ra = Renderer(CORNELL, opts=opts, resolution=(32, 32), trace_depth=4)
        rb = Renderer(CORNELL, opts=RenderOptions(sample_mode=SampleMode.MIS),
                      resolution=(32, 32), trace_depth=4)
        ra.step(2)   # 1 warm + nk=1
        ra.step(5)   # nk=4 + nk=1
        rb.step(7)
        assert ra.iteration == rb.iteration == 7
        _close(ra.img, rb.img)

    def test_env_inline_resolve(self, tmp_path):
        """Env scenes cash the deferred env radiance at refill time; the
        total must match the classic deferred-to-finish path."""
        img = 0.05 * np.ones((16, 32, 3), np.float32)
        img[4:7, 20:26] = 9.0  # bright patch: env misses carry real energy
        scene = make_env_scene(tmp_path, img)
        for env_is in (False, True):
            opts = RenderOptions(
                sample_mode=SampleMode.MIS, ray_regen=3, env_importance=env_is
            )
            ra = Renderer(scene, opts=opts, resolution=(32, 32), trace_depth=4)
            rb = Renderer(
                scene,
                opts=RenderOptions(
                    sample_mode=SampleMode.MIS, env_importance=env_is
                ),
                resolution=(32, 32), trace_depth=4,
            )
            ra.step(7)
            rb.step(7)
            _close(ra.img, rb.img)
            assert ra.stats.rays_traced == rb.stats.rays_traced

    def test_direct_li_ignores_regen(self):
        opts = RenderOptions(sample_mode=SampleMode.DIRECT_LI, ray_regen=4)
        r = Renderer(CORNELL, opts=opts, resolution=(16, 16), trace_depth=3)
        assert r._regen == 0
        r.step(2)  # still renders

    def test_rays_traced_matches_sequential(self):
        """The throughput metric counts the same reference-issuance ray set
        regardless of pool scheduling."""
        opts = RenderOptions(sample_mode=SampleMode.MIS, ray_regen=4)
        ra = Renderer(CORNELL, opts=opts, resolution=(32, 32), trace_depth=4)
        rb = Renderer(CORNELL, opts=RenderOptions(sample_mode=SampleMode.MIS),
                      resolution=(32, 32), trace_depth=4)
        ra.step(9)
        rb.step(9)
        assert ra.stats.rays_traced == rb.stats.rays_traced


def lit_soup_scene(tmp_path, n=600, seed=11):
    """tri_soup_scene's OBJ in a LIT scene (sphere light + floor): the
    bare soup has no emitter, so its renders are identically zero and any
    image comparison on it is vacuous — the r5 pre-sort-meta RNG bug
    passed the zero-image check and only showed in ray counts."""
    import textwrap

    soup = tri_soup_scene(tmp_path, n=n, seed=seed)
    obj = tmp_path / "soup.obj"
    scene = tmp_path / "lit_soup.txt"
    scene.write_text(
        textwrap.dedent(
            f"""
            MATERIAL light
            TYPE\tLight
            ALBEDO      6 6 6
            METALLIC    0
            ROUGHNESS   0
            IOR         0

            MATERIAL grey
            TYPE\tLambertian
            ALBEDO      .75 .75 .75
            METALLIC    0
            ROUGHNESS   0
            IOR         0

            CAMERA
            RES         64 64
            FOVY        45
            ITERATIONS  1
            DEPTH       4
            FILE        lit_soup
            EYE         0 0 10
            LOOKAT      0 0 0
            UP          0 1 0

            OBJECT soup
            {obj}
            material grey
            TRANS       0 0 0
            ROTAT       0 0 0
            SCALE       1 1 1

            OBJECT lamp
            sphere
            material light
            TRANS       0 5 2
            ROTAT       0 0 0
            SCALE       2 2 2

            OBJECT floor
            cube
            material grey
            TRANS       0 -4 0
            ROTAT       0 0 0
            SCALE       20 .1 20
            """
        )
    )
    return scene


class TestRegenMeshSortedPool:
    """Triangle path with the per-bounce purity sort + shrink ladder: the
    meta column must ride every sort and every shrink cut/merge, and the
    per-lane RNG keys must be read from the POST-sort pool.  Driven
    through the builder directly (fused XLA walk nests fine on CPU; the
    Renderer would go staged here).  The scene is LIT (sphere light →
    nonzero radiance + NEE shadow rays), so these checks are not vacuous."""

    @pytest.fixture(scope="class")
    def mesh_setup(self, tmp_path_factory):
        tmp = tmp_path_factory.mktemp("regen_mesh")
        scene = load_scene(lit_soup_scene(tmp, n=600, seed=11))
        scene.camera.resolution = (64, 64)
        scene.trace_depth = 4
        # the 128-lane shrink tile gives the ladder levels at 4096 lanes
        opts = RenderOptions(sample_mode=SampleMode.MIS, traversal="xla")
        flat, static = build_flat_scene(scene, opts=opts)
        assert static.num_tris >= 512  # the purity sort must be ON
        p, v, u, r, pl = derive_camera(scene.camera).as_arrays()
        cam = CameraArrays(*[jnp.asarray(x) for x in (p, v, u, r, pl)])
        # swizzled lane order: covers the ARITHMETIC swizzle inverse in the
        # regeneration refill (64x64 tiles exactly)
        order = swizzle_map(64, 64)
        xs = jnp.asarray((order % 64).astype(np.float32))
        ys = jnp.asarray((order // 64).astype(np.float32))
        return flat, static, opts, cam, (xs, ys)

    def test_batch_matches_sequential(self, mesh_setup):
        flat, static, opts, cam, pixel_xy = mesh_setup
        key = rng.base_key(0)
        n = 64 * 64
        img0 = jnp.zeros((n, 3), jnp.float32)

        seq = jax.jit(make_render_iteration(static, opts, 64, 64, pixel_xy=pixel_xy))
        img_seq = img0
        rays_seq = 0
        for it in range(1, 4):
            img_seq, rr, _ = seq(flat, cam, img_seq, jnp.int32(it), key)
            rays_seq += int(rr)

        batch = jax.jit(make_render_iteration(
            static, opts, 64, 64, pixel_xy=pixel_xy, regen_k=3
        ))
        img_b, rays_b, laps = batch(flat, cam, img0, jnp.int32(1), key, jnp.int32(3))
        assert float(jnp.sum(img_seq)) > 1.0  # the scene is actually lit
        _close(img_b, img_seq)
        # identical (pixel, sample) path set => identical ray issuance
        assert int(rays_b) == rays_seq
        assert int(laps) <= 3 * (static.trace_depth + 1)

    def test_nk1_bitwise(self, mesh_setup):
        flat, static, opts, cam, pixel_xy = mesh_setup
        key = rng.base_key(0)
        n = 64 * 64
        img0 = jnp.zeros((n, 3), jnp.float32)
        seq = jax.jit(make_render_iteration(static, opts, 64, 64, pixel_xy=pixel_xy))
        batch = jax.jit(make_render_iteration(
            static, opts, 64, 64, pixel_xy=pixel_xy, regen_k=3
        ))
        a, ra, _ = seq(flat, cam, img0, jnp.int32(2), key)
        b, rb, _ = batch(flat, cam, img0, jnp.int32(2), key, jnp.int32(1))
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert int(ra) == int(rb)

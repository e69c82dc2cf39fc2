"""End-to-end integrator physics tests (the test pyramid the reference lacks,
SURVEY.md §4): white-furnace energy conservation, emitter visibility,
cross-mode (BSDF vs NEE vs MIS) convergence agreement."""

import textwrap

import numpy as np
import pytest

from pathtracer.integrator.render import Renderer
from pathtracer.utils.config import RenderOptions, SampleMode
from pathtracer.utils.image_io import write_hdr


def write_scene(tmp_path, body, name="scene.txt"):
    p = tmp_path / name
    p.write_text(textwrap.dedent(body))
    return p


FURNACE_CAMERA = """
// Camera
CAMERA
RES         32 32
FOVY        45
ITERATIONS  100
DEPTH       {depth}
FILE        furnace
EYE         0 0 5
LOOKAT      0 0 0
UP          0 1 0
"""


@pytest.fixture()
def uniform_env(tmp_path):
    env = tmp_path / "white.hdr"
    write_hdr(env, np.ones((16, 32, 3), np.float32))
    return env


class TestFurnace:
    def test_lambertian_white_furnace(self, tmp_path, uniform_env):
        # albedo-1 diffuse sphere inside a radiance-1 environment must
        # converge to 1 everywhere (energy conservation)
        scene = write_scene(
            tmp_path,
            f"""
            MATERIAL white
            TYPE\tLambertian
            ALBEDO      1 1 1
            METALLIC    0
            ROUGHNESS   0
            IOR         0

            ENV {uniform_env}
            """
            + FURNACE_CAMERA.format(depth=32)
            + """
            OBJECT 0
            sphere
            material white
            TRANS       0 0 0
            ROTAT       0 0 0
            SCALE       2 2 2
            """,
        )
        r = Renderer(scene, opts=RenderOptions(sample_mode=SampleMode.BSDF, tonemapping=False))
        r.step(80)
        img = np.asarray(r.img / r.iteration).reshape(32, 32, 3)
        np.testing.assert_allclose(img.mean(), 1.0, atol=0.03)
        assert img.std() < 0.2

    def test_dielectric_furnace(self, tmp_path, uniform_env):
        # a lossless glass sphere in a uniform furnace also must return 1
        # (reflect+refract partition is energy conserving; the (ior2/ior1)²
        # radiance scales cancel over entry+exit)
        scene = write_scene(
            tmp_path,
            f"""
            MATERIAL glass
            TYPE\tDielectric
            ALBEDO      1 1 1
            METALLIC    0
            ROUGHNESS   0
            IOR         1.5

            ENV {uniform_env}
            """
            + FURNACE_CAMERA.format(depth=48)
            + """
            OBJECT 0
            sphere
            material glass
            TRANS       0 0 0
            ROTAT       0 0 0
            SCALE       2 2 2
            """,
        )
        r = Renderer(scene, opts=RenderOptions(sample_mode=SampleMode.BSDF, tonemapping=False))
        r.step(100)
        img = np.asarray(r.img / r.iteration).reshape(32, 32, 3)
        np.testing.assert_allclose(img.mean(), 1.0, atol=0.05)


class TestEmitters:
    def test_light_seen_directly(self, tmp_path):
        # camera staring at a large emissive cube: pixel = albedo (2,2,2)
        scene = write_scene(
            tmp_path,
            """
            MATERIAL L
            TYPE\tLight
            ALBEDO      2 1 0.5
            METALLIC    0
            ROUGHNESS   0
            IOR         0
            """
            + FURNACE_CAMERA.format(depth=4)
            + """
            OBJECT 0
            cube
            material L
            TRANS       0 0 -2
            ROTAT       0 0 0
            SCALE       40 40 1
            """,
        )
        for mode in (SampleMode.BSDF, SampleMode.MIS, SampleMode.DIRECT_LI):
            r = Renderer(scene, opts=RenderOptions(sample_mode=mode, tonemapping=False))
            r.step(4)
            img = np.asarray(r.img / r.iteration).reshape(32, 32, 3)
            center = img[8:24, 8:24]
            np.testing.assert_allclose(
                center.mean(axis=(0, 1)), [2, 1, 0.5], rtol=0.02,
                err_msg=f"mode={mode.name}",
            )

    def test_miss_is_black_without_env(self, tmp_path):
        scene = write_scene(
            tmp_path,
            """
            MATERIAL L
            TYPE\tLight
            ALBEDO      5 5 5
            METALLIC    0
            ROUGHNESS   0
            IOR         0
            """
            + FURNACE_CAMERA.format(depth=4)
            + """
            OBJECT 0
            sphere
            material L
            TRANS       0 0 -50
            ROTAT       0 0 0
            SCALE       1 1 1
            """,
        )
        r = Renderer(scene, opts=RenderOptions(sample_mode=SampleMode.BSDF, tonemapping=False))
        r.step(2)
        img = np.asarray(r.img).reshape(32, 32, 3)
        assert img[0, 0].max() == 0.0  # corner rays miss everything


MINI_CORNELL = """
MATERIAL light
TYPE\tLight
ALBEDO      8 8 8
METALLIC    0
ROUGHNESS   0
IOR         0

MATERIAL white
TYPE\tLambertian
ALBEDO      .8 .8 .8
METALLIC    0
ROUGHNESS   0
IOR         0

MATERIAL rough
TYPE\tMicrofacet
ALBEDO      .9 .6 .3
METALLIC    0
ROUGHNESS   0.4
IOR         0

// Camera
CAMERA
RES         48 48
FOVY        45
ITERATIONS  100
DEPTH       5
FILE        mini
EYE         0 2.5 6
LOOKAT      0 2.5 0
UP          0 1 0

OBJECT floor
cube
material white
TRANS       0 0 0
ROTAT       0 0 0
SCALE       10 .01 10

OBJECT back
cube
material white
TRANS       0 2.5 -3
ROTAT       0 0 0
SCALE       10 5 .01

OBJECT lamp
sphere
material light
TRANS       0 4.5 0
ROTAT       0 0 0
SCALE       1 1 1

OBJECT ball
sphere
material rough
TRANS       0 1 0
ROTAT       0 0 0
SCALE       2 2 2
"""


@pytest.mark.slow
class TestCrossModeConsistency:
    """BSDF sampling, NEE and MIS estimate the same integral; their converged
    images must agree (the reference validates this only by eye,
    README.md:10-16 — we make it a numeric test)."""

    @pytest.fixture(scope="class")
    def images(self, tmp_path_factory):
        tmp = tmp_path_factory.mktemp("xmode")
        scene = write_scene(tmp, MINI_CORNELL)
        out = {}
        for mode, spp in [
            (SampleMode.BSDF, 1500),
            (SampleMode.MIS, 400),
        ]:
            r = Renderer(scene, opts=RenderOptions(sample_mode=mode, tonemapping=False))
            r.step(spp)
            out[mode] = np.asarray(r.img / r.iteration).reshape(48, 48, 3)
        return out

    def test_bsdf_vs_mis(self, images):
        a = images[SampleMode.BSDF]
        b = images[SampleMode.MIS]
        # compare in tonemapped space to bound outlier influence
        ta = np.clip(a, 0, 1) ** (1 / 2.2)
        tb = np.clip(b, 0, 1) ** (1 / 2.2)
        rmse = np.sqrt(((ta - tb) ** 2).mean())
        assert rmse < 0.05, f"BSDF vs MIS rmse={rmse:.4f}"

    def test_nonzero_indirect(self, images):
        img = images[SampleMode.MIS]
        assert img.mean() > 0.02


class TestSortedPoolEquivalence:
    """The per-bounce ray sort and the straggler-phase pool shrink are pure reorderings: RNG keys on
    lane and contributions ride the ray, so both must be BIT-identical to
    the unsorted render (scenes with >=512 tris activate them)."""

    @pytest.fixture(scope="class")
    def images(self, tmp_path_factory):
        from dataclasses import replace

        from tests.test_traverse import tri_soup_scene

        tmp = tmp_path_factory.mktemp("sortpool")
        scene = tri_soup_scene(tmp, n=600)
        # the 128-lane shrink tile divides the tiny 64x32 test pool so
        # the shrink phase genuinely runs (the soup drops to <3% alive
        # after one bounce)
        base = RenderOptions(sample_mode=SampleMode.MIS, tonemapping=False)
        out = {}
        for name, o in {
            "unsorted": replace(base, compaction=False),
            "sorted": replace(base, pool_shrink=False),
            "shrunk": base,
            "half_shrunk": replace(base, shrink_half=True),
            "sparse_sort": replace(base, sort_every=2),
        }.items():
            r = Renderer(scene, opts=o, resolution=(64, 32), trace_depth=6)
            r.step(2)
            out[name] = np.asarray(r.img)
        return out

    def test_sorted_bit_identical(self, images):
        np.testing.assert_array_equal(images["unsorted"], images["sorted"])

    def test_shrunk_bit_identical(self, images):
        np.testing.assert_array_equal(images["unsorted"], images["shrunk"])

    def test_half_shrunk_bit_identical(self, images):
        # the pool/2 leading shrink level (shrink_half) is a pure
        # reordering like the quarter ladder — must not change a bit
        np.testing.assert_array_equal(images["unsorted"], images["half_shrunk"])

    def test_sparse_sort_bit_identical(self, images):
        # sort_every=2 skips every other re-sort: a pure scheduling change
        np.testing.assert_array_equal(images["unsorted"], images["sparse_sort"])

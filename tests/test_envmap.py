"""Environment-map importance sampling tests (the reference's unfinished
TODO, README.md:25-27): pdf consistency, furnace energy conservation with
importance sampling ON, and cross-mode agreement on an env-lit scene."""

import textwrap

import numpy as np
import jax.numpy as jnp
import pytest

from pathtracer.integrator.render import Renderer
from pathtracer.ops.envmap import env_pdf, sample_env
from pathtracer.scene.flatscene import build_flat_scene
from pathtracer.scene.parser import load_scene
from pathtracer.utils.config import RenderOptions, SampleMode
from pathtracer.utils.image_io import write_hdr


def make_env_scene(tmp_path, env_img, body_extra=""):
    env = tmp_path / "env.hdr"
    write_hdr(env, env_img)
    scene = tmp_path / "scene.txt"
    scene.write_text(
        textwrap.dedent(
            f"""
            MATERIAL white
            TYPE\tLambertian
            ALBEDO      .8 .8 .8
            METALLIC    0
            ROUGHNESS   0
            IOR         0

            ENV {env}

            CAMERA
            RES         48 48
            FOVY        45
            ITERATIONS  10
            DEPTH       6
            FILE        env
            EYE         0 1 6
            LOOKAT      0 1 0
            UP          0 1 0

            OBJECT ball
            sphere
            material white
            TRANS       0 1 0
            ROTAT       0 0 0
            SCALE       2 2 2
            """
        )
        + body_extra
    )
    return scene


class TestEnvSampling:
    @pytest.fixture(scope="class")
    def env_scene(self, tmp_path_factory):
        tmp = tmp_path_factory.mktemp("env")
        rng = np.random.default_rng(5)
        # bright patch in an otherwise dim sky
        img = 0.05 * np.ones((32, 64, 3), np.float32)
        img[8:12, 30:38] = 25.0
        scene = load_scene(make_env_scene(tmp, img))
        return build_flat_scene(scene)

    def test_pdf_consistency(self, env_scene):
        flat, static = env_scene
        rng = np.random.default_rng(6)
        u1 = jnp.asarray(rng.random(2000, dtype=np.float32))
        u2 = jnp.asarray(rng.random(2000, dtype=np.float32))
        u3 = jnp.asarray(rng.random(2000, dtype=np.float32))
        d, le, pdf_s = sample_env(flat, static, u1, u2, u3)
        # unit directions
        np.testing.assert_allclose(
            np.linalg.norm(np.asarray(d), axis=-1), 1.0, atol=1e-5
        )
        # pdf from sampling must match pdf queried for the same directions
        pdf_q = env_pdf(flat, static, d)
        ratio = np.asarray(pdf_s) / np.asarray(pdf_q)
        assert np.median(np.abs(ratio - 1.0)) < 0.02

    def test_samples_concentrate_on_bright_patch(self, env_scene):
        flat, static = env_scene
        rng = np.random.default_rng(7)
        u1 = jnp.asarray(rng.random(2000, dtype=np.float32))
        u2 = jnp.asarray(rng.random(2000, dtype=np.float32))
        u3 = jnp.asarray(rng.random(2000, dtype=np.float32))
        d, le, pdf = sample_env(flat, static, u1, u2, u3)
        lum = np.asarray(le).mean(-1)
        # most samples should land on the 25.0 patch
        assert (lum > 10).mean() > 0.8

    def test_pdf_integrates_to_one(self, env_scene):
        flat, static = env_scene
        # Monte-Carlo: E_uniform[pdf] * 4π = 1
        rng = np.random.default_rng(8)
        v = rng.normal(size=(20000, 3))
        v /= np.linalg.norm(v, axis=-1, keepdims=True)
        p = np.asarray(env_pdf(flat, static, jnp.asarray(v.astype(np.float32))))
        integral = p.mean() * 4.0 * np.pi
        assert abs(integral - 1.0) < 0.05


class TestEnvIntegration:
    def test_furnace_with_env_importance(self, tmp_path):
        # uniform radiance-1 sky + albedo-1 sphere: MIS with env NEE must
        # still converge to 1 (validates pdf bookkeeping end-to-end)
        img = np.ones((16, 32, 3), np.float32)
        env = tmp_path / "white.hdr"
        write_hdr(env, img)
        scene = tmp_path / "furnace.txt"
        scene.write_text(
            textwrap.dedent(
                f"""
                MATERIAL white
                TYPE\tLambertian
                ALBEDO      1 1 1
                METALLIC    0
                ROUGHNESS   0
                IOR         0

                ENV {env}

                CAMERA
                RES         32 32
                FOVY        45
                ITERATIONS  10
                DEPTH       32
                FILE        f
                EYE         0 0 5
                LOOKAT      0 0 0
                UP          0 1 0

                OBJECT ball
                sphere
                material white
                TRANS       0 0 0
                ROTAT       0 0 0
                SCALE       2 2 2
                """
            )
        )
        r = Renderer(
            scene,
            opts=RenderOptions(
                sample_mode=SampleMode.MIS, tonemapping=False, env_importance=True
            ),
        )
        r.step(60)
        img_out = np.asarray(r.img / r.iteration).reshape(32, 32, 3)
        np.testing.assert_allclose(img_out.mean(), 1.0, atol=0.04)

    @pytest.mark.slow
    def test_env_importance_matches_bsdf_mode(self, tmp_path_factory):
        tmp = tmp_path_factory.mktemp("envx")
        rng = np.random.default_rng(9)
        img = 0.1 * np.ones((16, 32, 3), np.float32)
        img[4:6, 10:14] = 8.0  # small bright sun
        scene_path = make_env_scene(tmp, img)
        imgs = {}
        for name, opts, spp in [
            ("bsdf", RenderOptions(sample_mode=SampleMode.BSDF, tonemapping=False), 900),
            (
                "mis_env",
                RenderOptions(
                    sample_mode=SampleMode.MIS, tonemapping=False, env_importance=True
                ),
                250,
            ),
        ]:
            r = Renderer(scene_path, opts=opts)
            r.step(spp)
            imgs[name] = np.asarray(r.img / r.iteration).reshape(48, 48, 3)
        a = np.clip(imgs["bsdf"], 0, 1) ** (1 / 2.2)
        b = np.clip(imgs["mis_env"], 0, 1) ** (1 / 2.2)
        rmse = np.sqrt(((a - b) ** 2).mean())
        assert rmse < 0.06, f"rmse={rmse}"

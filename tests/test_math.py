"""Unit tests for ops/math.py against scalar numpy ports of the reference
formulas (reference: src/utilities.h) plus distribution/property checks."""

import numpy as np
import jax.numpy as jnp
import pytest

from pathtracer.ops import math as m


def rand_dirs(n, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


class TestBasics:
    def test_aces_known_values(self):
        # ACES constants (reference: src/utilities.h:35-43)
        x = jnp.array([0.0, 0.18, 1.0, 10.0])
        y = np.asarray(m.aces_film(x))
        ref = np.clip((x * (2.51 * x + 0.03)) / (x * (2.43 * x + 0.59) + 0.14), 0, 1)
        np.testing.assert_allclose(y, np.asarray(ref), rtol=1e-6)
        assert y[0] == 0.0 and y[-1] <= 1.0

    def test_gamma(self):
        np.testing.assert_allclose(
            np.asarray(m.gamma_correction(jnp.array(0.5))), 0.5 ** (1 / 2.2), rtol=1e-6
        )

    def test_luminance(self):
        assert np.isclose(
            float(m.rgb_to_luminance(jnp.array([1.0, 1.0, 1.0]))), 1.0, atol=1e-4
        )

    def test_process_nan(self):
        v = jnp.array([1.0, np.nan, np.inf, -np.inf])
        np.testing.assert_array_equal(np.asarray(m.process_nan(v)), [1, 0, 0, 0])


class TestONB:
    def test_pixar_orthonormal(self):
        n = jnp.asarray(rand_dirs(256))
        t, b = m.onb_pixar(n)
        np.testing.assert_allclose(np.asarray(m.dot(t, t)), 1.0, atol=1e-4)
        np.testing.assert_allclose(np.asarray(m.dot(b, b)), 1.0, atol=1e-4)
        np.testing.assert_allclose(np.asarray(m.dot(t, n)), 0.0, atol=1e-4)
        np.testing.assert_allclose(np.asarray(m.dot(b, n)), 0.0, atol=1e-4)
        np.testing.assert_allclose(np.asarray(m.dot(t, b)), 0.0, atol=1e-4)

    def test_pixar_matches_reference_formula(self):
        # direct port of localRefMatrix_Pixar (reference: src/utilities.h:188-200)
        for n in rand_dirs(32, seed=3):
            x, y, z = n
            sz = 1.0 if z >= 0 else -1.0
            a = 1.0 / (sz + z)
            sx = sz * x
            b_ = x * y * a
            xp = np.array([sx * x * a - 1.0, sz * b_, sx])
            yp = np.array([b_, y * y * a - sz, y])
            t, b = m.onb_pixar(jnp.asarray(n))
            np.testing.assert_allclose(np.asarray(t), xp, atol=1e-5)
            np.testing.assert_allclose(np.asarray(b), yp, atol=1e-5)


class TestSampling:
    def test_cosine_hemisphere_distribution(self):
        n = jnp.asarray(np.tile([0.0, 0.0, 1.0], (20000, 1)).astype(np.float32))
        rng = np.random.default_rng(1)
        r = jnp.asarray(rng.random((20000, 2), dtype=np.float32))
        d = np.asarray(m.sample_hemisphere_cosine(n, r))
        assert (d[:, 2] >= -1e-6).all()
        # E[cosθ] = 2/3 for cosine-weighted hemisphere
        assert np.isclose(d[:, 2].mean(), 2.0 / 3.0, atol=0.01)

    def test_triangle_uniform_in_simplex(self):
        rng = np.random.default_rng(2)
        uv = np.asarray(
            m.sample_triangle_uniform(jnp.asarray(rng.random((5000, 2), np.float32)))
        )
        assert (uv >= 0).all() and (uv.sum(-1) <= 1 + 1e-6).all()
        # uniform coverage: mean barycentric u = 1/3
        assert np.isclose(uv[:, 0].mean(), 1 / 3, atol=0.02)

    def test_sphere_to_plane_ranges(self):
        d = jnp.asarray(rand_dirs(1000, 5))
        uv = np.asarray(m.sphere_to_plane(d))
        assert (uv[:, 0] >= 0).all() and (uv[:, 0] < 1).all()
        assert (uv[:, 1] >= 0).all() and (uv[:, 1] <= 1).all()
        # +y maps to v=1, -y to v=0
        up = np.asarray(m.sphere_to_plane(jnp.array([0.0, 1.0, 0.0])))
        assert np.isclose(up[1], 1.0, atol=1e-5)


class TestFresnelGGX:
    def test_fresnel_maxwell_normal_incidence(self):
        # R0 = ((n1-n2)/(n1+n2))^2 at cosθ=1
        f = float(m.fresnel_maxwell(jnp.array(1.0), 1.0, 1.5))
        assert np.isclose(f, ((1 - 1.5) / (1 + 1.5)) ** 2, atol=1e-6)

    def test_fresnel_maxwell_tir(self):
        # from glass to air beyond the critical angle → 1
        f = float(m.fresnel_maxwell(jnp.array(0.1), 1.5, 1.0))
        assert f == 1.0

    def test_fresnel_schlick_limits(self):
        assert np.isclose(float(m.fresnel_schlick(0.04, jnp.array(1.0))), 0.04)
        assert np.isclose(float(m.fresnel_schlick(0.04, jnp.array(0.0))), 1.0)

    def test_ndf_ggx_normalization(self):
        # ∫ D(m) cosθ dω = 1 over the hemisphere
        a2 = 0.25
        n_t = 20000
        rng = np.random.default_rng(7)
        # uniform hemisphere sampling
        u = rng.random((n_t, 2))
        cos_t = u[:, 0]
        d = np.asarray(m.ndf_ggx(jnp.asarray(cos_t, dtype=jnp.float32), a2))
        integral = (d * cos_t).mean() * 2 * np.pi
        assert np.isclose(integral, 1.0, rtol=0.05)

    def test_vndf_half_vectors_above_surface(self):
        n = jnp.asarray(np.tile([0.0, 0.0, 1.0], (4096, 1)).astype(np.float32))
        wo = jnp.asarray(rand_dirs(4096, 11))
        wo = jnp.where(wo[..., 2:3] < 0, -wo, wo)  # viewer above surface
        rng = np.random.default_rng(8)
        r = jnp.asarray(rng.random((4096, 2), np.float32))
        wh = np.asarray(m.sample_normal_ggx(n, wo, 0.3, r))
        np.testing.assert_allclose(np.linalg.norm(wh, axis=-1), 1.0, atol=1e-4)
        assert (wh[:, 2] > 0).all()

    def test_reflect_refract(self):
        n = jnp.array([0.0, 0.0, 1.0])
        wo = jnp.asarray(m.normalize(jnp.array([1.0, 0.0, -1.0])))  # into surface
        r = np.asarray(m.reflect_dir(n, wo))
        np.testing.assert_allclose(r, m.normalize(jnp.array([1.0, 0.0, 1.0])), atol=1e-6)
        # straight-through at equal ior
        t = np.asarray(m.refract_dir(n, wo, 1.0, 1.0))
        np.testing.assert_allclose(t, np.asarray(wo), atol=1e-6)
        # Snell check at 1.0 → 1.5
        t = np.asarray(m.refract_dir(n, wo, 1.0, 1.5))
        sin_in = np.sqrt(0.5)
        sin_out = np.linalg.norm(t[:2])
        assert np.isclose(sin_out, sin_in / 1.5, atol=1e-6)

    def test_power_heuristic(self):
        assert float(m.power_heuristic(jnp.array(1.0), jnp.array(1.0))) == 0.5
        assert np.isclose(float(m.power_heuristic(jnp.array(3.0), jnp.array(1.0))), 0.9)
        # reference quirk: negative g is squared (lightPDF returns -1 for
        # cube lights → weight f²/(f²+1), reference: src/lightSample.h:141-169)
        assert np.isclose(
            float(m.power_heuristic(jnp.array(1.0), jnp.array(-1.0))), 0.5
        )


class TestAlternateSamplers:
    """The reference's 'v2' sampler variants (reference: src/utilities.h:
    243-249, 379-397) kept for library parity."""

    def test_cosine2_distribution(self):
        n = jnp.asarray(np.tile([0.0, 0.0, 1.0], (20000, 1)).astype(np.float32))
        rng_ = np.random.default_rng(12)
        r = jnp.asarray(rng_.random((20000, 2), dtype=np.float32))
        d = np.asarray(m.sample_hemisphere_cosine2(n, r))
        assert (d[:, 2] >= -1e-5).all()
        assert np.isclose(d[:, 2].mean(), 2.0 / 3.0, atol=0.01)

    def test_vndf2_unit_and_hemisphere(self):
        n = jnp.asarray(np.tile([0.0, 0.0, 1.0], (4096, 1)).astype(np.float32))
        wo = jnp.asarray(rand_dirs(4096, 13))
        wo = jnp.where(wo[..., 2:3] < 0, -wo, wo)
        rng_ = np.random.default_rng(14)
        r = jnp.asarray(rng_.random((4096, 2), np.float32))
        wh = np.asarray(m.sample_normal_ggx2(n, wo, 0.3, r))
        np.testing.assert_allclose(np.linalg.norm(wh, axis=-1), 1.0, atol=1e-4)
        assert (wh[:, 2] >= 0).all()

    def test_random2d_range(self):
        w = jnp.asarray(rand_dirs(512, 15))
        r = np.asarray(m.random2d(w, 3))
        assert ((r >= 0) & (r < 1)).all()

"""Texture atlas sampling vs the reference's bilinear conventions
(reference: src/image.h:73-110) + distribution tests (reference:
src/distribution1D.cpp)."""

import numpy as np
import jax.numpy as jnp
import pytest

from pathtracer.ops.texture import bilinear_sample, sample_or_const
from pathtracer.utils.distribution import Distribution1D, Distribution2D


def ref_linear_sample(img, u, v):
    """Scalar port of devTexObj::linearSample (reference: src/image.h:73-85)."""
    h, w, _ = img.shape
    x = u * (w - 1)
    y = v * (h - 1)
    lx = int(x)
    ux = lx if x + 1 >= w else lx + 1
    ly = int(y)
    uy = ly if y + 1 >= h else ly + 1
    fx = x - np.floor(x)
    fy = y - np.floor(y)
    p1 = img[ly, lx] * (1 - fx) + img[ly, ux] * fx
    p2 = img[uy, lx] * (1 - fx) + img[uy, ux] * fx
    return p1 * (1 - fy) + p2 * fy


@pytest.fixture()
def atlas_setup():
    rng = np.random.default_rng(0)
    tex0 = rng.random((7, 5, 3)).astype(np.float32)
    tex1 = rng.random((4, 9, 3)).astype(np.float32)
    atlas = np.concatenate([tex0.reshape(-1, 3), tex1.reshape(-1, 3)]).T.copy()
    table = np.array([[0, 5, 7, 0], [35, 9, 4, 0]], np.int32)
    return tex0, tex1, jnp.asarray(atlas), jnp.asarray(table)


class TestBilinear:
    def test_matches_reference_formula(self, atlas_setup):
        tex0, tex1, atlas, table = atlas_setup
        rng = np.random.default_rng(1)
        uv = rng.random((64, 2)).astype(np.float32)
        tid = rng.integers(0, 2, 64).astype(np.int32)
        out = np.asarray(bilinear_sample(atlas, table, jnp.asarray(tid), jnp.asarray(uv)))
        for i in range(64):
            tex = tex0 if tid[i] == 0 else tex1
            expected = ref_linear_sample(tex, uv[i, 0], uv[i, 1])
            np.testing.assert_allclose(out[i], expected, rtol=1e-5, atol=1e-6)

    def test_corners_and_edges(self, atlas_setup):
        tex0, _, atlas, table = atlas_setup
        tid = jnp.zeros((4,), jnp.int32)
        uv = jnp.asarray([[0, 0], [1, 0], [0, 1], [1, 1]], jnp.float32)
        out = np.asarray(bilinear_sample(atlas, table, tid, uv))
        np.testing.assert_allclose(out[0], tex0[0, 0], rtol=1e-6)
        np.testing.assert_allclose(out[1], tex0[0, -1], rtol=1e-6)
        np.testing.assert_allclose(out[2], tex0[-1, 0], rtol=1e-6)
        np.testing.assert_allclose(out[3], tex0[-1, -1], rtol=1e-6)

    def test_const_fallback(self, atlas_setup):
        _, _, atlas, table = atlas_setup
        const = jnp.asarray(np.tile([0.3, 0.6, 0.9], (8, 1)).astype(np.float32))
        tid = jnp.full((8,), -1, jnp.int32)
        uv = jnp.zeros((8, 2), jnp.float32)
        out = np.asarray(sample_or_const(atlas, table, tid, const, uv))
        np.testing.assert_allclose(out, np.asarray(const))


class TestDistribution1D:
    def test_uniform(self):
        d = Distribution1D(np.ones(8))
        x, pdf = d.sample_continuous(jnp.asarray([0.0, 0.25, 0.5, 0.999]))
        np.testing.assert_allclose(np.asarray(x), [0.0, 0.25, 0.5, 0.999], atol=1e-5)
        np.testing.assert_allclose(np.asarray(pdf), 1.0, rtol=1e-6)

    def test_degenerate_zero(self):
        # all-zero → uniform (reference: distribution1D.cpp:24-31)
        d = Distribution1D(np.zeros(4))
        x, pdf = d.sample_continuous(jnp.asarray([0.1, 0.9]))
        np.testing.assert_allclose(np.asarray(x), [0.1, 0.9], atol=1e-5)

    def test_importance_concentration(self):
        f = np.array([0.0, 0.0, 10.0, 0.0])
        d = Distribution1D(f)
        rng = np.random.default_rng(2)
        x, pdf = d.sample_continuous(jnp.asarray(rng.random(1000, dtype=np.float32)))
        x = np.asarray(x)
        assert ((x >= 0.5) & (x < 0.75)).all()
        np.testing.assert_allclose(np.asarray(pdf), 4.0, rtol=1e-5)

    def test_discrete(self):
        d = Distribution1D(np.array([1.0, 3.0]))
        idx, pmf = d.sample_discrete(jnp.asarray([0.1, 0.9]))
        np.testing.assert_array_equal(np.asarray(idx), [0, 1])
        np.testing.assert_allclose(np.asarray(pmf), [0.25, 0.75], rtol=1e-5)


class TestDistribution2D:
    def test_sampling_distribution(self):
        f = np.zeros((8, 16))
        f[2, 5] = 4.0
        f[6, 10] = 12.0
        d = Distribution2D(f)
        rng = np.random.default_rng(3)
        u1 = jnp.asarray(rng.random(4000, dtype=np.float32))
        u2 = jnp.asarray(rng.random(4000, dtype=np.float32))
        uu, vv, pdf = d.sample(u1, u2)
        uu, vv = np.asarray(uu), np.asarray(vv)
        col = (uu * 16).astype(int)
        row = (vv * 8).astype(int)
        counts = {}
        for r, c in zip(row, col):
            counts[(r, c)] = counts.get((r, c), 0) + 1
        assert set(counts) == {(2, 5), (6, 10)}
        frac = counts[(6, 10)] / 4000
        assert abs(frac - 0.75) < 0.03

    def test_pdf_consistency(self):
        rng = np.random.default_rng(4)
        f = rng.random((6, 12)) + 0.1
        d = Distribution2D(f)
        u1 = jnp.asarray(rng.random(512, dtype=np.float32))
        u2 = jnp.asarray(rng.random(512, dtype=np.float32))
        uu, vv, pdf_s = d.sample(u1, u2)
        pdf_q = d.pdf(uu, vv)
        np.testing.assert_allclose(np.asarray(pdf_s), np.asarray(pdf_q), rtol=1e-3)


class TestPackedAtlas:
    """uint32-packed LDR atlas (material samplers): lossless vs the float
    path for 8-bit sources, 1 gather per tap."""

    def test_matches_float_path(self):
        from pathtracer.ops.texture import bilinear_sample, bilinear_sample_u32

        rng = np.random.default_rng(6)
        # 8-bit-quantized source, like PNG textures
        tex = (rng.integers(0, 256, (9, 13, 3)) / 255.0).astype(np.float32)
        flat = tex.reshape(-1, 3)
        atlas_f = jnp.asarray(flat.T.copy())
        q = np.clip(flat * 255.0 + 0.5, 0, 255).astype(np.uint32)
        atlas_u = jnp.asarray(q[:, 0] | (q[:, 1] << 8) | (q[:, 2] << 16))
        table = jnp.asarray(np.array([[0, 13, 9, 0]], np.int32))
        uv = jnp.asarray(rng.random((128, 2)).astype(np.float32))
        tid = jnp.zeros((128,), jnp.int32)
        a = np.asarray(bilinear_sample(atlas_f, table, tid, uv))
        b = np.asarray(bilinear_sample_u32(atlas_u, table, tid, uv))
        np.testing.assert_allclose(a, b, atol=1e-5)


    def test_rgbe_roundtrip(self):
        from pathtracer.ops.texture import bilinear_sample_u32

        rng = np.random.default_rng(7)
        hdr = (rng.random((6, 8, 3)) * 40.0).astype(np.float32)
        flat = hdr.reshape(-1, 3)
        maxc = flat.max(-1)
        e = np.where(maxc > 1e-32, np.floor(np.log2(maxc)) + 1, 0).astype(np.int32)
        scale = np.where(maxc > 1e-32, np.ldexp(1.0, -e) * 256.0, 0.0)
        q = np.clip(flat * scale[:, None], 0, 255).astype(np.uint32)
        eb = np.where(maxc > 1e-32, e + 128, 0).astype(np.uint32)
        atlas_u = jnp.asarray(q[:, 0] | (q[:, 1] << 8) | (q[:, 2] << 16) | (eb << 24))
        table = jnp.asarray(np.array([[0, 8, 6, 1]], np.int32))
        # sample exact texel centers → compare vs RGBE-decoded source
        xs = (np.arange(8) / 7.0).astype(np.float32)
        ys = (np.arange(6) / 5.0).astype(np.float32)
        uv = jnp.asarray(np.stack(np.meshgrid(xs, ys), -1).reshape(-1, 2))
        tid = jnp.zeros((48,), jnp.int32)
        out = np.asarray(bilinear_sample_u32(atlas_u, table, tid, uv))
        decoded = (q[:, :3].astype(np.float32) *
                   np.where(eb == 0, 0.0, np.exp2(eb.astype(np.float32) - 136.0))[:, None])
        np.testing.assert_allclose(out, decoded.reshape(6, 8, 3).reshape(-1, 3), rtol=1e-5)

"""Counter-based RNG quality + reproducibility tests."""

import numpy as np
import jax.numpy as jnp

from pathtracer.utils import rng


def draw(seed=0, it=1, depth=0, stage=1, n=50000, ncols=3):
    k = rng.base_key(seed)
    return np.asarray(
        rng.pixel_uniforms(
            k, jnp.int32(it), jnp.int32(depth), stage, jnp.arange(n, dtype=jnp.int32), ncols
        )
    )


class TestPixelUniforms:
    def test_range_and_moments(self):
        u = draw()
        assert u.min() >= 0.0 and u.max() < 1.0
        assert abs(u.mean() - 0.5) < 0.005
        assert abs(u.std() - np.sqrt(1 / 12)) < 0.005

    def test_uniformity_chi2(self):
        u = draw()[:, 0]
        h, _ = np.histogram(u, bins=20, range=(0, 1))
        exp = len(u) / 20
        chi2 = ((h - exp) ** 2 / exp).sum()
        assert chi2 < 45  # 19 dof; p<1e-3 would be ~43

    def test_decorrelation(self):
        u = draw()
        assert abs(np.corrcoef(u[:, 0], u[:, 1])[0, 1]) < 0.02
        assert abs(np.corrcoef(u[:-1, 0], u[1:, 0])[0, 1]) < 0.02

    def test_streams_differ(self):
        assert not np.allclose(draw(it=1), draw(it=2))
        assert not np.allclose(draw(depth=0), draw(depth=1))
        assert not np.allclose(draw(stage=1), draw(stage=2))
        assert not np.allclose(draw(seed=0), draw(seed=1))

    def test_position_stability(self):
        # pixel p draws the same values regardless of the pool's slicing —
        # the property that makes sharded renders match single-chip
        k = rng.base_key(0)
        full = np.asarray(
            rng.pixel_uniforms(k, jnp.int32(3), jnp.int32(2), 1, jnp.arange(1024, dtype=jnp.int32), 2)
        )
        part = np.asarray(
            rng.pixel_uniforms(
                k, jnp.int32(3), jnp.int32(2), 1, jnp.arange(256, 512, dtype=jnp.int32), 2
            )
        )
        np.testing.assert_array_equal(full[256:512], part)

    def test_deterministic(self):
        np.testing.assert_array_equal(draw(), draw())

    def test_per_lane_iteration_depth(self):
        # the regeneration path passes PER-LANE (iteration, depth) arrays;
        # each lane must draw bit-identically to the scalar-keyed call for
        # its own (iteration, depth)
        k = rng.base_key(3)
        pix = jnp.arange(64, dtype=jnp.int32)
        its = jnp.asarray(np.arange(64) % 5 + 1, jnp.int32)
        dps = jnp.asarray(np.arange(64) % 3, jnp.int32)
        mixed = np.asarray(rng.pixel_uniforms(k, its, dps, 1, pix, 3))
        for it in range(1, 6):
            for dp in range(3):
                sel = (np.arange(64) % 5 + 1 == it) & (np.arange(64) % 3 == dp)
                scalar = np.asarray(
                    rng.pixel_uniforms(
                        k, jnp.int32(it), jnp.int32(dp), 1, pix, 3
                    )
                )
                np.testing.assert_array_equal(mixed[sel], scalar[sel])

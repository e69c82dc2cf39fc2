"""Intersection primitive tests vs analytic expectations and reference
conventions (reference: src/intersections.h, src/Bounds3.hpp)."""

import numpy as np
import jax.numpy as jnp

from pathtracer.ops import intersect as ix
from pathtracer.scene.parser import build_transformation_matrix


def make_geom(trans=(0, 0, 0), rot=(0, 0, 0), scale=(1, 1, 1)):
    t = build_transformation_matrix(np.array(trans), np.array(rot), np.array(scale))
    inv = np.linalg.inv(t.astype(np.float64)).astype(np.float32)
    return jnp.asarray(t), jnp.asarray(inv), jnp.asarray(inv.T)


class TestSphere:
    def test_unit_sphere_head_on(self):
        t, inv, invt = make_geom()
        o = jnp.array([[0.0, 0.0, 5.0]])
        d = jnp.array([[0.0, 0.0, -1.0]])
        valid, dist, p, n, outside = ix.ray_sphere(t, inv, invt, o, d)
        assert bool(valid[0]) and bool(outside[0])
        assert np.isclose(float(dist[0]), 4.5, atol=1e-3)
        np.testing.assert_allclose(np.asarray(n[0]), [0, 0, 1], atol=1e-3)

    def test_scaled_translated(self):
        t, inv, invt = make_geom(trans=(2, 5, 2), scale=(4, 4, 4))  # radius 2
        o = jnp.array([[2.0, 5.0, 10.0]])
        d = jnp.array([[0.0, 0.0, -1.0]])
        valid, dist, p, n, outside = ix.ray_sphere(t, inv, invt, o, d)
        assert bool(valid[0])
        assert np.isclose(float(dist[0]), 6.0, atol=1e-2)

    def test_inside_sphere(self):
        t, inv, invt = make_geom(scale=(4, 4, 4))
        o = jnp.array([[0.0, 0.0, 0.0]])
        d = jnp.array([[0.0, 0.0, -1.0]])
        valid, dist, p, n, outside = ix.ray_sphere(t, inv, invt, o, d)
        assert bool(valid[0]) and not bool(outside[0])
        assert np.isclose(float(dist[0]), 2.0, atol=1e-2)
        # reference does NOT flip the normal for inside hits
        # (src/intersections.h:139-141 commented out)
        np.testing.assert_allclose(np.asarray(n[0]), [0, 0, -1], atol=1e-3)

    def test_miss(self):
        t, inv, invt = make_geom()
        valid, *_ = ix.ray_sphere(
            t, inv, invt, jnp.array([[0.0, 2.0, 5.0]]), jnp.array([[0.0, 0.0, -1.0]])
        )
        assert not bool(valid[0])


class TestCube:
    def test_wall_like_cube(self):
        # cornell back wall: SCALE .01 10 10 at (0,5,-5) rotated 90° about Y
        t, inv, invt = make_geom(trans=(0, 5, -5), rot=(0, 90, 0), scale=(0.01, 10, 10))
        o = jnp.array([[0.0, 5.0, 3.0]])
        d = jnp.array([[0.0, 0.0, -1.0]])
        valid, dist, p, n, outside = ix.ray_cube(t, inv, invt, o, d)
        assert bool(valid[0])
        assert np.isclose(float(dist[0]), 8.0, atol=0.05)
        np.testing.assert_allclose(np.asarray(n[0]), [0, 0, 1], atol=1e-3)

    def test_normals_each_face(self):
        t, inv, invt = make_geom()
        for axis in range(3):
            for sgn in (1.0, -1.0):
                o = np.zeros((1, 3), np.float32)
                o[0, axis] = 2.0 * sgn
                d = np.zeros((1, 3), np.float32)
                d[0, axis] = -sgn
                valid, dist, p, n, outside = ix.ray_cube(
                    t, inv, invt, jnp.asarray(o), jnp.asarray(d)
                )
                assert bool(valid[0])
                expected = np.zeros(3)
                expected[axis] = sgn
                np.testing.assert_allclose(np.asarray(n[0]), expected, atol=1e-4)
                assert np.isclose(float(dist[0]), 1.5, atol=1e-3)

    def test_inside_cube(self):
        t, inv, invt = make_geom(scale=(10, 10, 10))
        valid, dist, p, n, outside = ix.ray_cube(
            t, inv, invt, jnp.array([[0.0, 0.0, 0.0]]), jnp.array([[1.0, 0.0, 0.0]])
        )
        assert bool(valid[0]) and not bool(outside[0])
        assert np.isclose(float(dist[0]), 5.0, atol=1e-2)

    def test_axis_parallel_ray(self):
        t, inv, invt = make_geom()
        # grazing along +z at x=0.4 (inside slab) should hit
        valid, *_ = ix.ray_cube(
            t, inv, invt, jnp.array([[0.4, 0.0, 5.0]]), jnp.array([[0.0, 0.0, -1.0]])
        )
        assert bool(valid[0])
        # outside the x-slab, parallel → miss
        valid, *_ = ix.ray_cube(
            t, inv, invt, jnp.array([[0.7, 0.0, 5.0]]), jnp.array([[0.0, 0.0, -1.0]])
        )
        assert not bool(valid[0])


class TestTriangle:
    def test_hit_and_barycentrics(self):
        v0 = jnp.array([0.0, 0.0, 0.0])
        v1 = jnp.array([1.0, 0.0, 0.0])
        v2 = jnp.array([0.0, 1.0, 0.0])
        o = jnp.array([0.25, 0.25, 1.0])
        d = jnp.array([0.0, 0.0, -1.0])
        hit, t, u, v = ix.ray_triangle(v0, v1, v2, o, d)
        assert bool(hit)
        assert np.isclose(float(t), 1.0)
        assert np.isclose(float(u), 0.25) and np.isclose(float(v), 0.25)

    def test_t_zero_accepted(self):
        # reference accepts t >= 0 (src/Bounds3.hpp:323)
        v0 = jnp.array([0.0, 0.0, 0.0])
        v1 = jnp.array([1.0, 0.0, 0.0])
        v2 = jnp.array([0.0, 1.0, 0.0])
        hit, t, u, v = ix.ray_triangle(
            v0, v1, v2, jnp.array([0.25, 0.25, 0.0]), jnp.array([0.0, 0.0, -1.0])
        )
        assert bool(hit) and float(t) == 0.0

    def test_parallel_miss(self):
        v0 = jnp.array([0.0, 0.0, 0.0])
        v1 = jnp.array([1.0, 0.0, 0.0])
        v2 = jnp.array([0.0, 1.0, 0.0])
        hit, *_ = ix.ray_triangle(
            v0, v1, v2, jnp.array([0.0, 0.0, 1.0]), jnp.array([1.0, 0.0, 0.0])
        )
        assert not bool(hit)


class TestAABB:
    def test_basic(self):
        pmin = jnp.array([0.0, 0.0, 0.0])
        pmax = jnp.array([1.0, 1.0, 1.0])
        hit, t = ix.ray_aabb(pmin, pmax, jnp.array([0.5, 0.5, 5.0]), jnp.array([0.0, 0.0, -1.0]))
        assert bool(hit) and np.isclose(float(t), 4.0)

    def test_from_inside(self):
        pmin = jnp.array([0.0, 0.0, 0.0])
        pmax = jnp.array([1.0, 1.0, 1.0])
        hit, t = ix.ray_aabb(pmin, pmax, jnp.array([0.5, 0.5, 0.5]), jnp.array([0.0, 0.0, -1.0]))
        assert bool(hit)  # tExit > 0 condition (reference: Bounds3.hpp:188)

    def test_behind(self):
        pmin = jnp.array([0.0, 0.0, 0.0])
        pmax = jnp.array([1.0, 1.0, 1.0])
        hit, t = ix.ray_aabb(pmin, pmax, jnp.array([0.5, 0.5, 5.0]), jnp.array([0.0, 0.0, 1.0]))
        assert not bool(hit)

    def test_parallel_inside_outside(self):
        pmin = jnp.array([0.0, 0.0, 0.0])
        pmax = jnp.array([1.0, 1.0, 1.0])
        hit, _ = ix.ray_aabb(pmin, pmax, jnp.array([0.5, 0.5, 5.0]), jnp.array([0.0, 0.0, -1.0]))
        assert bool(hit)
        hit, _ = ix.ray_aabb(pmin, pmax, jnp.array([2.0, 0.5, 5.0]), jnp.array([0.0, 0.0, -1.0]))
        assert not bool(hit)

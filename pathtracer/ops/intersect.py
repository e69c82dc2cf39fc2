"""Vectorized ray–primitive intersection tests.

Rebuilds the reference's device intersection library
(reference: src/intersections.h:48-144, src/Bounds3.hpp:133-229,298-326) as
batched jnp ops.  All functions take (..., 3) ray origins/directions and
return per-ray results; invalid hits are flagged by a boolean mask (the
reference returns t = -1).

Exact conventions replicated:
- object-space direction is normalized before the analytic test, the hit is
  pulled back by 1e-4 along the object ray (getPointOnRay,
  reference: src/intersections.h:27-29), and t is re-derived as the WORLD
  distance |hit - origin|.
- cube slab test has no parallel-ray guard (division by 0 yields ±inf which
  flows through min/max correctly, reference: src/intersections.h:58-76).
- Möller–Trumbore accepts t >= 0 with no epsilon
  (reference: src/Bounds3.hpp:298-326).
"""

from __future__ import annotations

import jax.numpy as jnp

from pathtracer.ops.math import cross, dot, length, normalize


def xform_point(m, p):
    """(4,4) @ [p, 1] → (...,3).  m may be (4,4) or batched (...,4,4).

    Written as explicit multiply-adds, NOT einsum/dot: a 3-wide f32 matmul
    may run at reduced precision on a matrix unit (bfloat16 on some
    accelerators, TF32 on the GPU's tensor cores), and ~0.4% relative
    error in intersection distances breaks the occlusion epsilon windows
    (observed as false shadowing on sphere lights).  Elementwise
    multiply-adds stay in full float32.
    """
    x = m[..., 0, 0] * p[..., 0] + m[..., 0, 1] * p[..., 1] + m[..., 0, 2] * p[..., 2] + m[..., 0, 3]
    y = m[..., 1, 0] * p[..., 0] + m[..., 1, 1] * p[..., 1] + m[..., 1, 2] * p[..., 2] + m[..., 1, 3]
    z = m[..., 2, 0] * p[..., 0] + m[..., 2, 1] * p[..., 1] + m[..., 2, 2] * p[..., 2] + m[..., 2, 3]
    return jnp.stack([x, y, z], axis=-1)


def xform_vector(m, v):
    """(4,4) @ [v, 0] → (...,3); VPU multiply-adds (see xform_point)."""
    x = m[..., 0, 0] * v[..., 0] + m[..., 0, 1] * v[..., 1] + m[..., 0, 2] * v[..., 2]
    y = m[..., 1, 0] * v[..., 0] + m[..., 1, 1] * v[..., 1] + m[..., 1, 2] * v[..., 2]
    z = m[..., 2, 0] * v[..., 0] + m[..., 2, 1] * v[..., 1] + m[..., 2, 2] * v[..., 2]
    return jnp.stack([x, y, z], axis=-1)


def xform_point_cols(m, px, py, pz):
    """Column (SoA) form of xform_point: (N,) components in, 3 out.

    m's scalars may themselves be (N,) columns (winner-selected per ray).
    Column form keeps the op chain reduce-free so XLA fuses whole sweeps
    into a few HBM passes (the AoS sweep was ~50 small fusions/lap — see
    tools/sweep_probe.py, 3x).
    """
    return (m[0][0] * px + m[0][1] * py + m[0][2] * pz + m[0][3],
            m[1][0] * px + m[1][1] * py + m[1][2] * pz + m[1][3],
            m[2][0] * px + m[2][1] * py + m[2][2] * pz + m[2][3])


def xform_vector_cols(m, vx, vy, vz):
    """Column (SoA) form of xform_vector (see xform_point_cols)."""
    return (m[0][0] * vx + m[0][1] * vy + m[0][2] * vz,
            m[1][0] * vx + m[1][1] * vy + m[1][2] * vz,
            m[2][0] * vx + m[2][1] * vy + m[2][2] * vz)


def mat_rows(m):
    """(4,4) array → nested tuple of scalar slices for the _cols helpers."""
    return tuple(tuple(m[i, j] for j in range(4)) for i in range(3))


def normalize_cols(vx, vy, vz, eps=0.0):
    """Column form of math.normalize: v * where(n2>eps, 1/sqrt(max(n2,
    1e-38)), 0) — same formula, same rounding."""
    n2 = vx * vx + vy * vy + vz * vz
    inv = jnp.where(n2 > eps, 1.0 / jnp.sqrt(jnp.maximum(n2, 1e-38)), 0.0)
    return vx * inv, vy * inv, vz * inv


def ray_sphere(transform, inverse_transform, inv_transpose, o, d):
    """Unit sphere (radius 0.5) in object space.

    reference: src/intersections.h:102-144 (sphereIntersectionTest).
    Returns (valid, t, point, normal, outside); t is world distance.
    """
    ro = xform_point(inverse_transform, o)
    rd = normalize(xform_vector(inverse_transform, d))

    vdd = dot(ro, rd)
    radicand = vdd * vdd - (dot(ro, ro) - 0.25)
    has_root = radicand >= 0.0
    root = jnp.sqrt(jnp.maximum(radicand, 0.0))
    t1 = -vdd + root
    t2 = -vdd - root

    both_neg = (t1 < 0.0) & (t2 < 0.0)
    both_pos = (t1 > 0.0) & (t2 > 0.0)
    t_obj = jnp.where(both_pos, jnp.minimum(t1, t2), jnp.maximum(t1, t2))
    outside = both_pos
    valid = has_root & ~both_neg

    p_obj = ro + (t_obj - 1e-4)[..., None] * rd
    point = xform_point(transform, p_obj)
    normal = normalize(xform_vector(inv_transpose, p_obj))
    t = length(point - o)
    return valid, t, point, normal, outside


def ray_cube(transform, inverse_transform, inv_transpose, o, d):
    """Axis-aligned unit cube [-0.5, 0.5]^3 in object space.

    reference: src/intersections.h:48-90 (boxIntersectionTest).
    Returns (valid, t, point, normal, outside); t is world distance.
    """
    ro = xform_point(inverse_transform, o)
    rd = normalize(xform_vector(inverse_transform, d))

    # slab test per axis; division by zero produces ±inf as in the reference
    t1 = (-0.5 - ro) / rd
    t2 = (0.5 - ro) / rd
    ta = jnp.minimum(t1, t2)
    tb = jnp.maximum(t1, t2)
    n_sign = jnp.where(t2 < t1, 1.0, -1.0)  # reference: intersections.h:66

    # tmin = max over axes of ta, but only axes where ta > 0 participate
    # (reference: `if (ta > 0 && ta > tmin)`) — start from -1e38.
    ta_gated = jnp.where(ta > 0.0, ta, -1e38)
    tmin = jnp.max(ta_gated, axis=-1)
    tmin_axis = jnp.argmax(ta_gated, axis=-1)
    tmax = jnp.min(tb, axis=-1)
    tmax_axis = jnp.argmin(tb, axis=-1)

    hit = (tmax >= tmin) & (tmax > 0.0)
    inside = tmin <= 0.0
    t_obj = jnp.where(inside, tmax, tmin)
    axis = jnp.where(inside, tmax_axis, tmin_axis)
    outside = hit & ~inside

    # select-based: no take_along_axis / eye[axis] gathers from tiny tables
    is0 = (axis == 0)[..., None]
    is1 = (axis == 1)[..., None]
    sign = jnp.where(
        axis == 0,
        n_sign[..., 0],
        jnp.where(axis == 1, n_sign[..., 1], n_sign[..., 2]),
    )[..., None]
    basis0 = jnp.array([1.0, 0.0, 0.0], ro.dtype)
    basis1 = jnp.array([0.0, 1.0, 0.0], ro.dtype)
    basis2 = jnp.array([0.0, 0.0, 1.0], ro.dtype)
    n_obj = jnp.where(is0, basis0, jnp.where(is1, basis1, basis2)) * sign

    p_obj = ro + (t_obj - 1e-4)[..., None] * rd
    point = xform_point(transform, p_obj)
    normal = normalize(xform_vector(inv_transpose, n_obj))
    t = length(point - o)
    return hit, t, point, normal, outside


def ray_sphere_t(transform, inverse_transform, o, d):
    """Distance-only sphere test (valid, t) — the hot inner loop of the
    geom sweep; point/normal are recomputed once for the winning geom."""
    ro = xform_point(inverse_transform, o)
    rd = normalize(xform_vector(inverse_transform, d))
    vdd = dot(ro, rd)
    radicand = vdd * vdd - (dot(ro, ro) - 0.25)
    has_root = radicand >= 0.0
    root = jnp.sqrt(jnp.maximum(radicand, 0.0))
    t1 = -vdd + root
    t2 = -vdd - root
    both_neg = (t1 < 0.0) & (t2 < 0.0)
    both_pos = (t1 > 0.0) & (t2 > 0.0)
    t_obj = jnp.where(both_pos, jnp.minimum(t1, t2), jnp.maximum(t1, t2))
    valid = has_root & ~both_neg
    p_obj = ro + (t_obj - 1e-4)[..., None] * rd
    t = length(xform_point(transform, p_obj) - o)
    return valid, t


def ray_cube_t(transform, inverse_transform, o, d):
    """Distance-only cube test (valid, t)."""
    ro = xform_point(inverse_transform, o)
    rd = normalize(xform_vector(inverse_transform, d))
    t1 = (-0.5 - ro) / rd
    t2 = (0.5 - ro) / rd
    ta = jnp.minimum(t1, t2)
    tb = jnp.maximum(t1, t2)
    ta_gated = jnp.where(ta > 0.0, ta, -1e38)
    tmin = jnp.max(ta_gated, axis=-1)
    tmax = jnp.min(tb, axis=-1)
    hit = (tmax >= tmin) & (tmax > 0.0)
    t_obj = jnp.where(tmin <= 0.0, tmax, tmin)
    p_obj = ro + (t_obj - 1e-4)[..., None] * rd
    t = length(xform_point(transform, p_obj) - o)
    return hit, t


def ray_triangle(v0, v1, v2, o, d):
    """Möller–Trumbore (reference: src/Bounds3.hpp:298-326 Triangle::getInterSect).

    Returns (hit, t, u, v) with hitpoint = (1-u-v)*v0 + u*v1 + v*v2.
    """
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    inv_det = 1.0 / jnp.where(det == 0.0, 1.0, det)

    tvec = o - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det

    hit = (det != 0.0) & (t >= 0.0) & (u >= 0.0) & (v >= 0.0) & (1.0 - u - v >= 0.0)
    return hit, t, u, v


def ray_aabb(pmin, pmax, o, d):
    """Slab AABB test returning (hit, t_enter).

    reference: src/Bounds3.hpp:163-189 (IntersectP(ray, t)): hit iff
    tEnter <= tExit && tExit > 0; t = tEnter.  Zero direction components
    fall back to an origin-containment check on that axis.
    """
    inv = 1.0 / d
    lo = (pmin - o) * inv
    hi = (pmax - o) * inv
    tmin = jnp.minimum(lo, hi)
    tmax = jnp.maximum(lo, hi)

    zero = d == 0.0
    inside_axis = (o >= pmin) & (o <= pmax)
    # parallel + outside slab → force a miss; parallel + inside → ignore axis
    tmin = jnp.where(zero, jnp.where(inside_axis, -jnp.inf, jnp.inf), tmin)
    tmax = jnp.where(zero, jnp.where(inside_axis, jnp.inf, -jnp.inf), tmax)

    t_enter = jnp.max(tmin, axis=-1)
    t_exit = jnp.min(tmax, axis=-1)
    hit = (t_enter <= t_exit) & (t_exit > 0.0)
    return hit, t_enter

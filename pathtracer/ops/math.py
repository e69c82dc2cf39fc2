"""Vectorized math & sampling library.

Rebuild of the reference's device math library
(reference: src/utilities.h:31-443).  Every function is pure jnp, operates on
batched arrays with a trailing component axis for vectors ((..., 3)), and is
safe under jit/vmap/shard_map.  Conventions (sign choices, clamps, epsilons)
replicate the reference exactly so renders agree statistically; divergences
are noted inline.
"""

from __future__ import annotations

import jax.numpy as jnp

from pathtracer.utils.config import INV_PI, PI, TWO_PI

# ---------------------------------------------------------------------------
# small helpers


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def length(v):
    return jnp.sqrt(jnp.maximum(dot(v, v), 0.0))


def length2(v):
    return dot(v, v)


def normalize(v, eps=0.0):
    n2 = dot(v, v)
    inv = jnp.where(n2 > eps, 1.0 / jnp.sqrt(jnp.maximum(n2, 1e-38)), 0.0)
    return v * inv[..., None]


def cross(a, b):
    return jnp.cross(a, b)


def mix(a, b, t):
    return a * (1.0 - t) + b * t


def pow5(x):
    """reference: src/utilities.h:269-273"""
    x2 = x * x
    return x2 * x2 * x


def sqr(x):
    return x * x


def process_nan(v):
    """Scrub NaN/Inf to 0 before accumulation (reference: src/utilities.h:275-283)."""
    return jnp.where(jnp.isfinite(v), v, 0.0)


def rgb_to_luminance(rgb):
    """reference: src/utilities.h:154-157"""
    return 0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2]


# ---------------------------------------------------------------------------
# tonemapping (reference: src/utilities.h:35-48)


def aces_film(x):
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return jnp.clip((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def gamma_correction(x):
    return jnp.power(jnp.maximum(x, 0.0), 1.0 / 2.2)


# ---------------------------------------------------------------------------
# orthonormal bases


def onb_pixar(n):
    """Branchless Pixar/Frisvad ONB; returns (tangent, bitangent).

    reference: src/utilities.h:188-200 (localRefMatrix_Pixar).  `n` need not be
    unit length for the reference either (it is called with normalized inputs).
    """
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    sz = jnp.where(z >= 0.0, 1.0, -1.0)
    a = 1.0 / (sz + z)
    sx = sz * x
    b = x * y * a
    t = jnp.stack([sx * x * a - 1.0, sz * b, sx], axis=-1)
    bt = jnp.stack([b, y * y * a - sz, y], axis=-1)
    return t, bt


def onb_ref2(n):
    """The reference's second frame (localRefMatrix2, src/utilities.h:166-171).

    Used by normal-map application fallbacks and 'v2' samplers.
    """
    up = jnp.where(
        (jnp.abs(n[..., 1]) > 0.9999)[..., None],
        jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), n.shape),
        jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0]), n.shape),
    )
    b = normalize(cross(n, up))
    t = cross(b, n)
    return t, b


# ---------------------------------------------------------------------------
# mappings & primitive samplers


def sphere_to_plane(d):
    """Equirect direction→uv (reference: src/utilities.h:209-214)."""
    u = jnp.mod(jnp.arctan2(d[..., 2], d[..., 0]) * INV_PI * 0.5 + 1.0, 1.0)
    v = jnp.maximum(
        jnp.arctan2(d[..., 1], jnp.hypot(d[..., 0], d[..., 2])) * INV_PI + 0.5, 0.0
    )
    return jnp.stack([u, v], axis=-1)


def sample_triangle_uniform(r):
    """Uniform barycentric (u, v) (reference: src/utilities.h:218-222)."""
    t = jnp.sqrt(r[..., 0])
    return jnp.stack([1.0 - t, t * (1.0 - r[..., 1])], axis=-1)


def to_concentric_disk(r):
    """reference: src/utilities.h:237-241 (actually polar, kept name)."""
    rad = jnp.sqrt(r[..., 0])
    th = r[..., 1] * TWO_PI
    return jnp.stack([jnp.cos(th), jnp.sin(th)], axis=-1) * rad[..., None]


def sample_uniform_disc(r):
    """reference: src/utilities.h:296-301"""
    rad = jnp.sqrt(r[..., 0])
    th = TWO_PI * r[..., 1]
    return jnp.stack([rad * jnp.cos(th), rad * jnp.sin(th)], axis=-1)


def sample_hemisphere_cosine(n, r):
    """Cosine-weighted hemisphere around n via the Pixar ONB.

    reference: src/utilities.h:224-235 (sampleHemisphereCosine).
    """
    t, b = onb_pixar(n)
    r1, r2 = r[..., 0], r[..., 1]
    sin_t = jnp.sqrt(r1)
    cos_t = jnp.sqrt(jnp.maximum(1.0 - r1, 0.0))
    phi = TWO_PI * r2
    x = sin_t * jnp.cos(phi)
    y = sin_t * jnp.sin(phi)
    return x[..., None] * t + y[..., None] * b + cos_t[..., None] * n


def sample_hemisphere_cosine2(n, r):
    """The reference's alternate cosine sampler (concentric disk + the
    localRefMatrix2 frame; reference: src/utilities.h:243-249) — kept for
    inventory parity with the 'v2' material implementations."""
    d = to_concentric_disk(r)
    z = jnp.sqrt(jnp.maximum(1.0 - dot(d, d), 0.0))
    t, b = onb_ref2(n)
    return d[..., 0:1] * t + d[..., 1:2] * b + z[..., None] * n


def sample_normal_ggx2(n, wo, alpha, r):
    """The reference's alternate VNDF sampler (localRefMatrix2 frame,
    max(0,·) z-clamp; reference: src/utilities.h:379-397)."""
    t, b = onb_ref2(n)
    wol = jnp.stack([dot(wo, t), dot(wo, b), dot(wo, n)], axis=-1)
    a = jnp.expand_dims(jnp.asarray(alpha, wol.dtype), -1)
    vh = normalize(jnp.concatenate([wol[..., :2] * a, wol[..., 2:]], axis=-1))
    len_sq = vh[..., 0] ** 2 + vh[..., 1] ** 2
    t1 = jnp.where(
        (len_sq > 0.0)[..., None],
        jnp.stack([-vh[..., 1], vh[..., 0], jnp.zeros_like(len_sq)], axis=-1)
        / jnp.sqrt(jnp.maximum(len_sq, 1e-38))[..., None],
        jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0]), vh.shape),
    )
    t2 = cross(vh, t1)
    p = sample_uniform_disc(r)
    s = 0.5 * (vh[..., 2] + 1.0)
    py = (1.0 - s) * jnp.sqrt(jnp.maximum(1.0 - p[..., 0] ** 2, 0.0)) + s * p[..., 1]
    p = jnp.stack([p[..., 0], py], axis=-1)
    h = (
        p[..., 0:1] * t1
        + p[..., 1:2] * t2
        + jnp.sqrt(jnp.maximum(0.0, 1.0 - dot(p, p)))[..., None] * vh
    )
    local = jnp.concatenate([h[..., :2] * a, jnp.maximum(0.0, h[..., 2:])], axis=-1)
    world = local[..., 0:1] * t + local[..., 1:2] * b + local[..., 2:3] * n
    return normalize(world)


def random2d(w, ite):
    """Hash-fract RNG (reference: src/utilities.h:66-70 random2D) — unused by
    the reference's kernels but part of its library surface."""
    r1 = jnp.mod(
        jnp.sin(dot(w, jnp.array([12.9898, 78.233, 45.645])) + ite * 25.345)
        * 43758.5453,
        1.0,
    )
    r2 = jnp.mod(
        jnp.sin(dot(w, jnp.array([45.432, 234.233, 99.99])) + ite * 42.345) * 219.23,
        1.0,
    )
    return jnp.stack([r1, r2], axis=-1)


def sample_hemisphere_uniform(n, r):
    """reference: src/utilities.h:251-262"""
    t, b = onb_pixar(n)
    cos_t = 1.0 - r[..., 0]
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
    phi = TWO_PI * r[..., 1]
    x = sin_t * jnp.cos(phi)
    y = sin_t * jnp.sin(phi)
    return x[..., None] * t + y[..., None] * b + cos_t[..., None] * n


# ---------------------------------------------------------------------------
# reflection / refraction / Fresnel


def reflect_dir(n, wo):
    """Reflect incoming dir `wo` about the wo-facing side of n.

    reference: src/utilities.h:290-294 (getReflectDir); wo points INTO the
    surface (it is the ray direction).
    """
    nf = jnp.where((dot(wo, n) < 0.0)[..., None], n, -n)
    return wo - 2.0 * nf * dot(wo, nf)[..., None]


def reflect(i, n):
    """glm::reflect(I, N) = I - 2*dot(N,I)*N."""
    return i - 2.0 * dot(n, i)[..., None] * n


def refract_dir(n, wo, ior1, ior2):
    """Refract from medium ior1 into ior2 (reference: src/utilities.h:311-320).

    NOTE: replicates the reference exactly, including producing NaN at total
    internal reflection (callers gate on Fresnel==1 first).  We clamp the
    radicand at 0 instead of NaN; the dielectric sampler never reaches this
    branch at TIR because FresnelMaxwell returns 1 there.
    """
    nf = jnp.where((dot(wo, n) < 0.0)[..., None], n, -n)
    eta = jnp.expand_dims(jnp.asarray(ior1 / ior2, wo.dtype), -1)
    r_perp = (wo - dot(wo, nf)[..., None] * nf) * eta
    k = jnp.maximum(1.0 - length2(r_perp), 0.0)
    r_para = -jnp.sqrt(k)[..., None] * nf
    return r_perp + r_para


def fresnel_schlick(f0, cos_theta):
    """reference: src/utilities.h:322-330; f0 may be scalar or (...,3)."""
    w = pow5(1.0 - cos_theta)
    if jnp.ndim(f0) and f0.shape[-1:] == (3,):
        return f0 + (1.0 - f0) * w[..., None]
    return f0 + (1.0 - f0) * w


def fresnel_maxwell(cos_theta1, ior1, ior2):
    """Exact unpolarized Fresnel (reference: src/utilities.h:332-342).

    Returns 1.0 at total internal reflection (sinTheta2 > 1).
    """
    sin1 = jnp.sqrt(jnp.maximum(1.0 - cos_theta1 * cos_theta1, 0.0))
    sin2 = sin1 * ior1 / ior2
    cos2 = jnp.sqrt(jnp.maximum(1.0 - sin2 * sin2, 0.0))
    r_para = (ior1 * cos2 - ior2 * cos_theta1) / (ior1 * cos2 + ior2 * cos_theta1)
    r_perp = (ior1 * cos_theta1 - ior2 * cos2) / (ior1 * cos_theta1 + ior2 * cos2)
    f = 0.5 * (r_para * r_para + r_perp * r_perp)
    return jnp.where(sin2 > 1.0, 1.0, f)


# ---------------------------------------------------------------------------
# GGX microfacet model


def ndf_ggx(cos_theta, a2):
    """GGX normal distribution D (reference: src/utilities.h:421-430)."""
    denom = cos_theta * cos_theta * (a2 - 1.0) + 1.0
    denom = denom * denom * PI
    d = a2 / jnp.maximum(denom, 1e-38)
    return jnp.where(cos_theta < 1e-6, 0.0, d)


def smith_g1(a2, nov):
    """reference: src/utilities.h:413-418"""
    denom = jnp.sqrt(jnp.maximum(nov * nov * (1.0 - a2) + a2, 0.0)) + nov
    return 2.0 * nov / jnp.where(denom == 0.0, 1e-38, denom)


def smith_g2(a2, nov, nol):
    """Height-correlated Smith G2 approximation (reference: src/utilities.h:406-411).

    NOTE the reference passes `roughness` (NOT alpha^2) as `a2` from
    microfacetBSDF (src/material.h:256) — replicated at call sites.
    """
    denom = nol * jnp.sqrt(jnp.maximum(nov * nov * (1.0 - a2) + a2, 0.0)) + nov * jnp.sqrt(
        jnp.maximum(nol * nol * (1.0 - a2) + a2, 0.0)
    )
    return 2.0 * nov * nol / jnp.where(denom == 0.0, 1e-38, denom)


def sample_normal_ggx(n, wo, alpha, r):
    """Sample a visible GGX half-vector (Heitz 2018 VNDF).

    reference: src/utilities.h:351-377 (sampleNormalGGX).  `wo` points AWAY
    from the surface (the caller passes -ray_dir).  `alpha` is whatever the
    call site passes (microfacet passes roughness, metallic passes
    roughness^2 — replicated faithfully at those call sites).
    """
    t, b = onb_pixar(n)
    # world→local: rows are (t, b, n)
    wol = jnp.stack([dot(wo, t), dot(wo, b), dot(wo, n)], axis=-1)
    a = jnp.expand_dims(jnp.asarray(alpha, wol.dtype), -1)  # broadcasts over xy
    wh = normalize(
        jnp.concatenate([wol[..., :2] * a, wol[..., 2:]], axis=-1)
    )
    wh = jnp.where((wh[..., 2] < 0.0)[..., None], -wh, wh)

    z_axis = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), wh.shape)
    t1 = jnp.where(
        (wh[..., 2] < 0.99999)[..., None],
        normalize(cross(z_axis, wh)),
        jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0]), wh.shape),
    )
    t2 = cross(wh, t1)

    p = sample_uniform_disc(r)
    h = jnp.sqrt(jnp.maximum(1.0 - sqr(p[..., 0]), 0.0))
    lerp_t = (1.0 + wh[..., 2]) / 2.0
    py = (1.0 - lerp_t) * h + lerp_t * p[..., 1]
    p = jnp.stack([p[..., 0], py], axis=-1)
    pz = jnp.sqrt(jnp.maximum(0.0, 1.0 - dot(p, p)))
    nh = p[..., 0:1] * t1 + p[..., 1:2] * t2 + pz[..., None] * wh

    local = jnp.concatenate(
        [nh[..., :2] * a, jnp.maximum(1e-6, nh[..., 2:])], axis=-1
    )
    world = local[..., 0:1] * t + local[..., 1:2] * b + local[..., 2:3] * n
    return normalize(world)


# ---------------------------------------------------------------------------
# MIS heuristics (reference: src/utilities.h:432-442)


def power_heuristic(f_pdf, g_pdf):
    f2, g2 = f_pdf * f_pdf, g_pdf * g_pdf
    return f2 / jnp.where(f2 + g2 == 0.0, 1e-38, f2 + g2)


def balance_heuristic(f_pdf, g_pdf):
    return f_pdf / jnp.where(f_pdf + g_pdf == 0.0, 1e-38, f_pdf + g_pdf)

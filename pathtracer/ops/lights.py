"""Next-event estimation: light sampling + pdf evaluation.

Rebuild of the reference's LightSampler
(reference: src/lightSample.h:18-249).  Replicated semantics, including
documented quirks (SURVEY.md §2 row 12, §7):

- uniform light pick: id = min(u * L, L-1) (reference: lightSample.h:178)
- triangle lights: uniform-area sample, solid-angle-converted pdf
  (1/L) · d² / (area · |cosθ|), two-sided (reference: lightSample.h:186-200)
- sphere lights: cone sampling in OBJECT space assuming radius 0.5 —
  non-uniform scales give a wrong pdf exactly as in the reference
  (reference: lightSample.h:202-234)
- CUBE area lights have NO sampling branch: pdf stays 0 so NEE contributes
  nothing for them, and lightPDF returns -1 (so the MIS weight becomes
  f²/(f²+1)) (reference: lightSample.h:171-234,141-169)
- occlusion ray starts at viewPos + 1e-5·dir (reference: lightSample.h:237)
- occluded ⇒ pdf = -1, emit = 0 (reference: lightSample.h:238-243)

Performance note: analytic (sphere/cube) lights are UNROLLED over the
static light list so their transforms fold to compile-time constants
instead of per-ray gathered (N,4,4) matrices (ROADMAP R3 asks whether
that still pays on the GPU).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from pathtracer.ops import math as m
from pathtracer.ops.intersect import xform_point
from pathtracer.ops.traverse import occlusion_test
from pathtracer.scene.flatscene import FlatScene, SceneStatic
from pathtracer.scene.parser import SPHERE
from pathtracer.utils.config import TWO_PI


class LightSampleRecord(NamedTuple):
    pos: jnp.ndarray   # (N, 3)
    emit: jnp.ndarray  # (N, 3)
    pdf: jnp.ndarray   # (N,)  (-1 = occluded / invalid)


def _tri_light_geometry(flat: FlatScene, tri_id):
    tidx = jnp.clip(tri_id, 0, flat.tri_data.shape[0] - 1)
    trow = flat.tri_data[tidx]
    v0, v1, v2 = trow[:, 0:3], trow[:, 3:6], trow[:, 6:9]
    n0, n1, n2 = trow[:, 9:12], trow[:, 12:15], trow[:, 15:18]
    return v0, v1, v2, n0, n1, n2


def _sphere_cone_sample_const(tr, inv, view_pos, xi):
    """Cone sampling toward ONE sphere light with compile-time-constant
    transforms (reference: lightSample.h:202-234)."""
    view_l = xform_point(inv, view_pos)
    center_to_ref = m.normalize(-view_l)
    tan, bit = m.onb_pixar(center_to_ref)

    d2 = m.dot(view_l, view_l)
    sin_tm2 = 0.25 / jnp.maximum(d2, 1e-12)
    cos_tm = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin_tm2))
    cos_t = (1.0 - xi[:, 0]) + xi[:, 0] * cos_tm
    sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
    phi = xi[:, 1] * TWO_PI

    dc = jnp.sqrt(jnp.maximum(d2, 0.0))
    ds = dc * cos_t - jnp.sqrt(jnp.maximum(0.0, 0.25 - dc * dc * sin_t * sin_t))
    sin_a = ds * sin_t / 0.5
    cos_a = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin_a * sin_a))

    n_obj = (
        (sin_a * jnp.cos(phi))[..., None] * tan
        + (sin_a * jnp.sin(phi))[..., None] * bit
        + cos_a[..., None] * (-center_to_ref)
    )
    p_obj = n_obj * 0.5
    light_pos = xform_point(tr, p_obj)
    pdf = 1.0 / (TWO_PI * (1.0 - cos_tm))
    return light_pos, pdf


def _sphere_cone_pdf_const(inv, view_pos):
    """Solid-angle pdf of the cone toward one sphere light
    (reference: lightSample.h:157-167)."""
    view_l = xform_point(inv, view_pos)
    sin_tm2 = 0.25 / jnp.maximum(m.dot(view_l, view_l), 1e-12)
    cos_tm = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin_tm2))
    return 1.0 / (TWO_PI * (1.0 - cos_tm))


def _emit_color_by_geom(flat: FlatScene, static: SceneStatic, geom_idx):
    """Light albedo via static geom→material chain (no tiny-table gathers).

    `geom_idx` comes from flat.light_geom, so only geoms with a LIGHT
    material can ever match — the chain selects over those alone, deduped
    by material id (geoms sharing a material share the albedo), instead of
    every geom in the scene.  Bit-identical: non-light masks never fired.
    """
    from pathtracer.scene.parser import LIGHT

    groups: dict[int, list[int]] = {}
    for gi, (mid, mty) in enumerate(zip(static.geom_mats, static.geom_mat_types)):
        if mty == LIGHT:
            groups.setdefault(int(mid), []).append(gi)
    out = jnp.zeros(geom_idx.shape + (3,), jnp.float32)
    for mid, gis in groups.items():
        mask = geom_idx == gis[0]
        for gi in gis[1:]:
            mask = mask | (geom_idx == gi)
        # light albedos are compile-time facts — immediates, not table reads
        val = jnp.array(static.mat_rows_f[mid][0:3], jnp.float32)
        out = jnp.where(mask[..., None], val, out)
    return out


def light_sample(
    flat: FlatScene, static: SceneStatic, view_pos, rands,
    include_env: bool = False, use_bvh: bool = True, enabled=None,
    traversal: str = "xla",
) -> LightSampleRecord:
    """Sample one light per ray, with occlusion.

    `rands` is (N, 3) — col 0 the light pick, cols 1-2 the area/cone
    sample — or (N, 4) when `include_env`, col 3 being the env texel
    jitter's second axis.
    With `include_env` the environment map participates as one more light
    (importance-sampled via its luminance·sinθ CDF) — our completion of the
    reference's env-MIS TODO (README.md:25-27), off by default.
    """
    N = view_pos.shape[0]
    L = static.num_lights
    L_eff = L + (1 if include_env else 0)
    if L_eff == 0:
        zero = jnp.zeros((N,), jnp.float32)
        return LightSampleRecord(
            pos=jnp.zeros((N, 3), jnp.float32),
            emit=jnp.zeros((N, 3), jnp.float32),
            pdf=zero - 1.0,
        )
    fl = jnp.float32(L_eff)
    light_id = jnp.minimum(rands[:, 0] * fl, fl - 1.0).astype(jnp.int32)
    is_env = light_id >= L  # env takes the last slot when included
    lid = jnp.clip(light_id, 0, flat.light_geom.shape[0] - 1)
    geom_id = flat.light_geom[lid]
    tri_id = jnp.where(is_env, -1, flat.light_tri[lid])
    emit = _emit_color_by_geom(flat, static, geom_id)

    xi = rands[:, 1:3]
    inv_l = 1.0 / fl

    light_pos = jnp.zeros((N, 3), jnp.float32)
    pdf = jnp.zeros((N,), jnp.float32)

    # triangle branch (reference: lightSample.h:186-200) — note the
    # reference's barycentric convention: pos = u·v0 + v·v1 + (1-u-v)·v2
    is_tri = tri_id >= 0
    if L > len(static.analytic_lights):  # triangle lights exist
        bary = m.sample_triangle_uniform(xi)
        u, v = bary[:, 0], bary[:, 1]
        v0, v1, v2, n0, n1, n2 = _tri_light_geometry(flat, tri_id)
        tri_pos = (
            u[..., None] * v0 + v[..., None] * v1 + (1.0 - u - v)[..., None] * v2
        )
        tri_nrm = m.normalize(
            u[..., None] * n0 + v[..., None] * n1 + (1.0 - u - v)[..., None] * n2
        )
        area = m.length(m.cross(v1 - v0, v2 - v0)) / 2.0
        d2 = m.length2(tri_pos - view_pos)
        cos_l = jnp.abs(m.dot(m.normalize(view_pos - tri_pos), tri_nrm))
        tri_pdf = inv_l * d2 / jnp.maximum(area * cos_l, 1e-38)
        tm = is_tri[..., None]
        light_pos = jnp.where(tm, tri_pos, light_pos)
        pdf = jnp.where(is_tri, tri_pdf, pdf)

    # analytic lights, unrolled over the static list (constant transforms);
    # cubes intentionally have no branch (pdf stays 0)
    for li, gi, gtype in static.analytic_lights:
        if gtype != SPHERE:
            continue
        p_i, pdf_i = _sphere_cone_sample_const(
            flat.geom_transform[gi], flat.geom_inv[gi], view_pos, xi
        )
        sel = light_id == li
        light_pos = jnp.where(sel[..., None], p_i, light_pos)
        pdf = jnp.where(sel, pdf_i * inv_l, pdf)

    if include_env:
        from pathtracer.ops.envmap import sample_env

        env_dir, env_le, env_pdf_w = sample_env(
            flat, static, xi[:, 0], xi[:, 1], rands[:, 3]
        )
        em = is_env[..., None]
        light_pos = jnp.where(em, view_pos + env_dir * 1e7, light_pos)
        pdf = jnp.where(is_env, env_pdf_w * inv_l, pdf)
        emit = jnp.where(em, env_le, emit)

    ray_dir = m.normalize(light_pos - view_pos)
    # `enabled` masks lanes whose NEE term is provably zero downstream
    # (dead rays, light hits, delta BSDFs): their shadow rays are never
    # traced
    occ_on = pdf > 0.0 if enabled is None else (pdf > 0.0) & enabled
    occ = occlusion_test(
        flat, static, view_pos + 1e-5 * ray_dir, ray_dir, light_pos,
        enabled=occ_on, use_bvh=use_bvh, traversal=traversal,
    )
    pdf = jnp.where(occ, -1.0, pdf)
    emit = jnp.where(occ[..., None], 0.0, emit)
    return LightSampleRecord(pos=light_pos, emit=emit, pdf=pdf)


def light_pdf(flat: FlatScene, static: SceneStatic, view_pos, light_pos, normal, tri_id, geom_id, include_env: bool = False):
    """Re-evaluate the light pdf for a BSDF-sampled hit (MIS weight).

    reference: src/lightSample.h:141-169 lightPDF.  Returns -1 for
    geometries with no sampling branch (cube lights).
    """
    N = view_pos.shape[0]
    L = static.num_lights + (1 if include_env else 0)
    if L == 0:
        return jnp.full((N,), -1.0, jnp.float32)
    inv_l = 1.0 / jnp.float32(L)

    pdf = jnp.full((N,), -1.0, jnp.float32)

    # triangle branch
    is_tri = tri_id >= 0
    v0, v1, v2, *_ = _tri_light_geometry(flat, tri_id)
    area = m.length(m.cross(v1 - v0, v2 - v0)) / 2.0
    d2 = m.length2(light_pos - view_pos)
    cos_l = jnp.abs(m.dot(m.normalize(view_pos - light_pos), normal))
    tri_pdf = inv_l * d2 / jnp.maximum(area * cos_l, 1e-38)
    pdf = jnp.where(is_tri, tri_pdf, pdf)

    # sphere branch: unrolled over static SPHERE geoms (overrides,
    # reference: lightSample.h:157-167 — any sphere geom, not just lights)
    for gi, gtype in enumerate(static.geom_types):
        if gtype != SPHERE:
            continue
        sph_pdf = _sphere_cone_pdf_const(flat.geom_inv[gi], view_pos) * inv_l
        sel = geom_id == gi
        pdf = jnp.where(sel, sph_pdf, pdf)
    return pdf

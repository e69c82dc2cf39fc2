"""BSDF library: eval / sample / pdf for all five material types.

Rebuild of the reference's tagged-union Material class
(reference: src/material.h:29-539).  Instead of a per-thread switch, every
lobe is evaluated vectorized over the whole wavefront and combined with
masked selects (the lobes are cheap elementwise math; no divergence).

Semantics replicated exactly, including quirks (SURVEY.md §7):
- `wo` passed around is the RAY direction (pointing INTO the surface); the
  GGX lobes negate it internally (reference: src/pathtrace.cu:460 passes
  pathSegments.ray.direction).
- Dielectric is a delta lobe: exact Fresnel chooses reflect/refract,
  refraction carries the (ior2²/ior1²) radiance scale, and the returned
  bsdf is divided by |cos| so the integrator's cosine cancels
  (reference: src/material.h:81-114).
- Microfacet passes `roughness` (not alpha²) to Smith G, and `roughness` as
  the VNDF alpha; MetallicWorkflow passes roughness² to the VNDF
  (reference: src/material.h:246-357).
- Light materials return (albedo-constant, pdf=1) from scatterSample
  (reference: src/material.h:472-475) — note the emission uses the CONSTANT
  albedo member, never the texture sampler.
- roughness is clamped to [1e-3, 1] and metallic to [0, 1] at sample time
  (reference: src/material.h:274,324-325).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from pathtracer.ops import math as m
from pathtracer.ops.texture import (
    bilinear_sample_u32_1ch_meta,
    bilinear_sample_u32_meta,
    sample_or_const,
)
from pathtracer.scene.flatscene import FlatScene, SceneStatic
from pathtracer.scene.parser import (
    DIELECTRIC,
    LAMBERTIAN,
    LIGHT,
    METALLIC_WORKFLOW,
    MICROFACET,
)
from pathtracer.utils.config import INV_PI

ROUGHNESS_MIN = 1e-3
ROUGHNESS_MAX = 1.0


class MatParams(NamedTuple):
    """Per-ray gathered & texture-resolved material parameters."""

    type: jnp.ndarray         # (N,) int32
    albedo: jnp.ndarray       # (N, 3) sampled (texture or constant)
    roughness: jnp.ndarray    # (N,) clamped
    metallic: jnp.ndarray     # (N,) clamped
    ior: jnp.ndarray          # (N,)
    emit: jnp.ndarray         # (N, 3) CONSTANT albedo (Light emission)
    normal_map: jnp.ndarray   # (N, 3) normal-map texel (0.5,0.5,1 if none)
    has_normal_map: jnp.ndarray  # (N,) bool


class ScatterRecord(NamedTuple):
    """reference: src/material.h:20-27 scatter_record."""

    bsdf: jnp.ndarray   # (N, 3)
    pdf: jnp.ndarray    # (N,)
    delta: jnp.ndarray  # (N,) bool
    dir: jnp.ndarray    # (N, 3)


def material_by_geom(flat: FlatScene, static: SceneStatic, geom_idx, uv) -> MatParams:
    """Material params selected by (dynamic) geom index via a static chain.

    Geoms' material assignments are compile-time facts, so each parameter
    component is a select-chain over per-material masks with scalar table
    reads at STATIC indices — zero gathers (this was chosen on the machine
    the code was first tuned on; ROADMAP R4 and D5 revisit it).

    Two dedupe levels, both bit-identical to the naive per-geom chain
    (each lane matches at most one geom, so merged masks pick the same
    value):
    - geoms sharing a material id share EVERY component, so masks are
      built once per UNIQUE material and OR'd over the group's geoms;
    - material params are compile-time facts (static.mat_rows_f/i), so
      each component chain selects between IMMEDIATES, grouped by VALUE —
      a component equal across materials (metallic on a typical cornell,
      every tex id on untextured scenes) compiles to a constant or a
      single select instead of one select per material.
    """
    ids = static.geom_mats
    groups: dict[int, list[int]] = {}
    for gi, mid in enumerate(ids):
        groups.setdefault(int(mid), []).append(gi)
    masks = []
    for mid, gis in groups.items():
        mask = geom_idx == gis[0]
        for gi in gis[1:]:
            mask = mask | (geom_idx == gi)
        masks.append((mid, mask))

    def chain_fn(getval, dtype):
        by_val: dict = {}
        for mid, mask in masks:
            by_val.setdefault(getval(mid), []).append(mask)
        out = jnp.zeros_like(geom_idx, dtype=dtype)
        for v, ms in by_val.items():
            if v == 0:  # matches the unmatched-lane default — free
                continue
            mask = ms[0]
            for mm in ms[1:]:
                mask = mask | mm
            out = jnp.where(mask, dtype(v), out)
        return out

    def chain(rows, comp, dtype):
        return chain_fn(lambda mid: rows[mid][comp], dtype)

    sf, si = static.mat_rows_f, static.mat_rows_i
    const_albedo = jnp.stack(
        [chain(sf, 0, jnp.float32), chain(sf, 1, jnp.float32), chain(sf, 2, jnp.float32)],
        axis=-1,
    )
    rough_c = chain(sf, 3, jnp.float32)
    metal_c = chain(sf, 4, jnp.float32)
    ior = chain(sf, 5, jnp.float32)
    mtype = chain(si, 0, jnp.int32)

    def tex_meta(comp):
        """Per-lane texture metadata for material tex slot `comp`:
        (offset, width, height, has_tex, rgbe) — all chained IMMEDIATES
        from SceneStatic.tex_rows instead of a per-lane (T, 4) tex_table
        row gather (tiny-table row gathers lower to serial strided
        fusions, CLAUDE.md rules 2-3).  Values match table[tid] exactly
        for textured lanes; untextured lanes get 0s, discarded by the
        has_tex select just like sample_or_const's tid<0 select."""
        trs = static.tex_rows

        def val(mid, k):
            t = si[mid][comp]
            return trs[t][k] if t >= 0 else 0

        offset = chain_fn(lambda mid: val(mid, 0), jnp.int32)
        width = chain_fn(lambda mid: val(mid, 1), jnp.int32)
        height = chain_fn(lambda mid: val(mid, 2), jnp.int32)
        has = chain_fn(lambda mid: si[mid][comp] >= 0, jnp.bool_)
        fmts = {trs[si[mid][comp]][3] for mid, _ in masks if si[mid][comp] >= 0}
        rgbe = (
            chain_fn(lambda mid: bool(val(mid, 3)), jnp.bool_)
            if len(fmts) > 1
            else bool(fmts and fmts == {1})
        )
        return offset, width, height, has, rgbe

    # a slot is live only if a material actually USED by a geom carries the
    # map (static.tex_slots is any-material; an unused textured material
    # would otherwise emit 4 wasted atlas gathers per lane)
    used = lambda comp: any(si[mid][comp] >= 0 for mid, _ in masks)
    slot_a, slot_m, slot_r, slot_n = (
        static.tex_slots[0] and used(1),
        static.tex_slots[1] and used(2),
        static.tex_slots[2] and used(3),
        static.tex_slots[3] and used(4),
    )
    if slot_a:
        off, w, h, has, rgbe = tex_meta(1)
        tex = bilinear_sample_u32_meta(flat.atlas_u32, off, w, h, rgbe, uv)
        albedo = jnp.where(has[..., None], tex, const_albedo)
    else:
        albedo = const_albedo
    if slot_r:
        off, w, h, has, _ = tex_meta(3)
        tex = bilinear_sample_u32_1ch_meta(flat.atlas_u32, off, w, h, uv)
        rough = jnp.where(has, tex, rough_c)
    else:
        rough = rough_c
    if slot_m:
        off, w, h, has, _ = tex_meta(2)
        tex = bilinear_sample_u32_1ch_meta(flat.atlas_u32, off, w, h, uv)
        metal = jnp.where(has, tex, metal_c)
    else:
        metal = metal_c
    nmap_const = jnp.broadcast_to(
        jnp.array([0.5, 0.5, 1.0], jnp.float32), const_albedo.shape
    )
    has_nmap = chain_fn(lambda mid: si[mid][4] >= 0, jnp.bool_)
    if slot_n:
        off, w, h, has, rgbe = tex_meta(4)
        tex = bilinear_sample_u32_meta(flat.atlas_u32, off, w, h, rgbe, uv)
        nmap = jnp.where(has[..., None], tex, nmap_const)
    else:
        nmap = nmap_const
    return MatParams(
        type=mtype,
        albedo=albedo,
        roughness=jnp.clip(rough, ROUGHNESS_MIN, ROUGHNESS_MAX),
        metallic=jnp.clip(metal, 0.0, 1.0),
        ior=ior,
        emit=const_albedo,
        normal_map=nmap,
        has_normal_map=has_nmap,
    )


def gather_material(flat: FlatScene, static: SceneStatic, mat_id, uv) -> MatParams:
    """Gather material params + resolve texture-or-constant samplers.

    Tables are component-major (8, M): each component is an independent
    (N,) gather.
    """
    mid = jnp.clip(mat_id, 0, flat.mat_f32.shape[1] - 1)
    f = flat.mat_f32
    i = flat.mat_i32
    const_albedo = jnp.stack([f[0][mid], f[1][mid], f[2][mid]], axis=-1)
    rough_c = f[3][mid]
    metal_c = f[4][mid]
    ior = f[5][mid]
    mtype = i[0][mid]
    atex, mtex, rtex, ntex = i[1][mid], i[2][mid], i[3][mid], i[4][mid]
    if static.has_textures:
        albedo = sample_or_const(flat.atlas, flat.tex_table, atex, const_albedo, uv)
        rough = sample_or_const(
            flat.atlas, flat.tex_table, rtex, rough_c[:, None], uv
        )[:, 0]
        metal = sample_or_const(
            flat.atlas, flat.tex_table, mtex, metal_c[:, None], uv
        )[:, 0]
        nmap_const = jnp.broadcast_to(
            jnp.array([0.5, 0.5, 1.0], jnp.float32), const_albedo.shape
        )
        nmap = sample_or_const(flat.atlas, flat.tex_table, ntex, nmap_const, uv)
    else:
        albedo = const_albedo
        rough = rough_c
        metal = metal_c
        nmap = jnp.broadcast_to(
            jnp.array([0.5, 0.5, 1.0], jnp.float32), const_albedo.shape
        )
    return MatParams(
        type=mtype,
        albedo=albedo,
        roughness=jnp.clip(rough, ROUGHNESS_MIN, ROUGHNESS_MAX),
        metallic=jnp.clip(metal, 0.0, 1.0),
        ior=ior,
        emit=const_albedo,
        normal_map=nmap,
        has_normal_map=ntex >= 0,
    )


# ---------------------------------------------------------------------------
# individual lobes (all take wo = ray direction INTO the surface)


def _lambertian_sample(p: MatParams, n, wo, r):
    bsdf = p.albedo * INV_PI
    d = m.sample_hemisphere_cosine(n, r[:, 0:2])
    pdf = m.dot(d, n) * INV_PI
    return bsdf, pdf, d


def _dielectric_sample(p: MatParams, n, wo, r):
    """reference: src/material.h:81-114 dielectricScatterSample."""
    entering = m.dot(wo, n) < 0.0
    ior1 = jnp.where(entering, 1.0, p.ior)
    ior2 = jnp.where(entering, p.ior, 1.0)
    fres = m.fresnel_maxwell(jnp.abs(m.dot(wo, n)), ior1, ior2)
    reflectp = r[:, 2] < fres

    refl = m.reflect_dir(n, wo)
    refr = m.refract_dir(n, wo, ior1, ior2)
    d = jnp.where(reflectp[..., None], refl, refr)
    scale = jnp.where(reflectp, 1.0, (ior2 * ior2) / (ior1 * ior1))
    bsdf = p.albedo * scale[..., None]
    bsdf = bsdf / jnp.maximum(jnp.abs(m.dot(d, n)), 1e-38)[..., None]
    pdf = jnp.ones_like(fres)
    return bsdf, pdf, d


def microfacet_bsdf(n, wo_out, wi, albedo, rough):
    """reference: src/material.h:246-260 (wo_out points AWAY from surface)."""
    a2 = rough * rough
    cos_o = m.dot(n, wo_out)
    cos_i = m.dot(n, wi)
    wm = m.normalize(wo_out + wi)
    d = m.ndf_ggx(m.dot(wm, n), a2)
    g2 = m.smith_g2(rough, cos_o, cos_i)  # quirk: roughness, not alpha²
    f = m.fresnel_schlick(albedo, m.dot(wo_out, wm))
    val = f * (d * g2 / jnp.maximum(4.0 * cos_o * cos_i, 1e-8))[..., None]
    return jnp.where((cos_o * cos_i < 1e-7)[..., None], 0.0, val)


def microfacet_pdf(n, wo_out, wi, rough):
    """reference: src/material.h:262-270."""
    a2 = rough * rough
    cos_o = m.dot(n, wo_out)
    wm = m.normalize(wo_out + wi)
    d = m.ndf_ggx(m.dot(wm, n), a2)
    g1 = m.smith_g1(rough, cos_o)  # quirk: roughness, not alpha²
    return g1 * d / jnp.maximum(4.0 * m.dot(wo_out, n), 1e-8)


def _microfacet_sample(p: MatParams, n, wo, r):
    """reference: src/material.h:272-294 (VNDF alpha = roughness, unsquared)."""
    wo_out = -wo
    wm = m.sample_normal_ggx(n, wo_out, p.roughness, r[:, 0:2])
    d = m.reflect(wo, wm)
    bad = m.dot(d, n) * m.dot(wo_out, n) < 0.0
    bsdf = microfacet_bsdf(n, wo_out, d, p.albedo, p.roughness)
    pdf = microfacet_pdf(n, wo_out, d, p.roughness)
    bsdf = jnp.where(bad[..., None], 0.0, bsdf)
    pdf = jnp.where(bad, 0.0, pdf)
    return bsdf, pdf, d


def metallic_bsdf(n, wo_out, wi, albedo, rough, metal):
    """reference: src/material.h:296-310 metallicBSDF."""
    a2 = rough * rough
    cos_o = m.dot(n, wo_out)
    cos_i = m.dot(n, wi)
    wm = m.normalize(wo_out + wi)
    d = m.ndf_ggx(m.dot(wm, n), a2)
    g2 = m.smith_g2(rough, cos_o, cos_i)  # quirk: roughness as a2
    f0 = m.mix(jnp.full_like(albedo, 0.08), albedo, metal[..., None])
    f = m.fresnel_schlick(f0, m.dot(wo_out, wm))
    diff = (1.0 - metal)[..., None] * albedo * INV_PI
    spec = (d * g2 / jnp.maximum(4.0 * cos_o * cos_i, 1e-8))[..., None]
    val = m.mix(diff, jnp.broadcast_to(spec, diff.shape), f)
    return jnp.where((cos_o * cos_i < 1e-7)[..., None], 0.0, val)


def metallic_pdf(n, wo_out, wi, rough, metal):
    """reference: src/material.h:312-320 metallicPDF."""
    a2 = rough * rough
    cos_o = m.dot(n, wo_out)
    wm = m.normalize(wo_out + wi)
    d = m.ndf_ggx(m.dot(wm, n), a2)
    g1 = m.smith_g1(rough, cos_o)  # quirk
    spec_pdf = g1 * d / jnp.maximum(4.0 * m.dot(wo_out, n), 1e-8)
    diff_pdf = m.dot(wi, n) * INV_PI
    return m.mix(diff_pdf, spec_pdf, 1.0 / (2.0 - metal))


def _metallic_sample(p: MatParams, n, wo, r):
    """reference: src/material.h:322-357 (VNDF alpha = roughness², lobe pick
    with prob 1/(2-metallic))."""
    wo_out = -wo
    spec_prob = 1.0 / (2.0 - p.metallic)
    pick_spec = r[:, 2] < spec_prob
    wm = m.sample_normal_ggx(n, wo_out, p.roughness * p.roughness, r[:, 0:2])
    d_spec = m.reflect(wo, wm)
    d_diff = m.sample_hemisphere_cosine(n, r[:, 0:2])
    d = jnp.where(pick_spec[..., None], d_spec, d_diff)
    bad = (m.dot(wo_out, n) < 0.0) | (m.dot(d, n) < 0.0)
    bsdf = metallic_bsdf(n, wo_out, d, p.albedo, p.roughness, p.metallic)
    pdf = metallic_pdf(n, wo_out, d, p.roughness, p.metallic)
    bsdf = jnp.where(bad[..., None], 0.0, bsdf)
    pdf = jnp.where(bad, 0.0, pdf)
    return bsdf, pdf, d


# ---------------------------------------------------------------------------
# dispatchers (reference: src/material.h:450-521)


def scatter_sample(p: MatParams, n, wo, rands, present=None) -> ScatterRecord:
    """Sample an outgoing direction + bsdf + pdf for every ray.

    `rands` is (N, 3): cols 0-1 are the 2D sample, col 2 the lobe/Fresnel
    1D sample.  reference: src/material.h:450-481 scatterSample.
    `present` (static tuple of material types in the scene) skips absent
    lobes entirely.
    """
    t = p.type
    bsdf = p.emit  # Light default (reference: material.h:472-475)
    pdf = jnp.ones_like(p.roughness)
    d = jnp.zeros_like(n)

    samplers = {
        LAMBERTIAN: _lambertian_sample,
        DIELECTRIC: _dielectric_sample,
        MICROFACET: _microfacet_sample,
        METALLIC_WORKFLOW: _metallic_sample,
    }
    for mtype, fn in samplers.items():
        if present is not None and mtype not in present:
            continue
        b_i, p_i, d_i = fn(p, n, wo, rands)
        sel = t == mtype
        bsdf = jnp.where(sel[..., None], b_i, bsdf)
        pdf = jnp.where(sel, p_i, pdf)
        d = jnp.where(sel[..., None], d_i, d)
    delta = t == DIELECTRIC
    return ScatterRecord(bsdf=bsdf, pdf=pdf, delta=delta, dir=d)


def bsdf_eval(p: MatParams, n, wo, wi, present=None):
    """reference: src/material.h:483-501 BSDF (wo = ray dir into surface)."""
    wo_out = -wo
    t = p.type
    out = jnp.zeros_like(p.albedo)

    def has(mt):
        return present is None or mt in present

    if has(LAMBERTIAN):
        out = jnp.where((t == LAMBERTIAN)[..., None], p.albedo * INV_PI, out)
    if has(MICROFACET):
        out = jnp.where(
            (t == MICROFACET)[..., None],
            microfacet_bsdf(n, wo_out, wi, p.albedo, p.roughness),
            out,
        )
    if has(METALLIC_WORKFLOW):
        out = jnp.where(
            (t == METALLIC_WORKFLOW)[..., None],
            metallic_bsdf(n, wo_out, wi, p.albedo, p.roughness, p.metallic),
            out,
        )
    return out


def pdf_eval(p: MatParams, n, wo, wi, present=None):
    """reference: src/material.h:503-521 pdf."""
    wo_out = -wo
    t = p.type
    out = jnp.zeros_like(p.roughness)

    def has(mt):
        return present is None or mt in present

    if has(LAMBERTIAN):
        out = jnp.where(t == LAMBERTIAN, m.dot(wi, n) * INV_PI, out)
    if has(MICROFACET):
        out = jnp.where(
            t == MICROFACET, microfacet_pdf(n, wo_out, wi, p.roughness), out
        )
    if has(METALLIC_WORKFLOW):
        out = jnp.where(
            t == METALLIC_WORKFLOW,
            metallic_pdf(n, wo_out, wi, p.roughness, p.metallic),
            out,
        )
    return out

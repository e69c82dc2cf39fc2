"""HDR environment-map sampling.

The reference builds a luminance·sin(θ) CDF over the env map but never
samples it — env importance sampling is an explicit TODO
(reference: src/scene.cpp:514-529 CDF build; README.md:25-27 "MIS env map").
This module finishes the job (gated by RenderOptions.env_importance):

- `sample_env`: draw a direction ∝ luminance·sinθ via the marginal/
  conditional CDFs (inverse of the equirect mapping sphere_to_plane,
  reference: src/utilities.h:209-214), returning (dir, radiance, pdf_ω)
- `env_pdf`: the same pdf for a given direction (the MIS counterweight
  when a BSDF-sampled ray escapes to the sky)

Solid-angle conversion: with u→φ=2πu, v→elevation θe=π(v-½), the Jacobian
gives pdf_ω = pdf_uv / (2π² · cosθe).
"""

from __future__ import annotations

import jax.numpy as jnp

from pathtracer.ops.texture import bilinear_sample_u32_meta
from pathtracer.scene.flatscene import FlatScene, SceneStatic
from pathtracer.utils.config import PI, TWO_PI


def sample_env(flat: FlatScene, static: SceneStatic, u1, u2, u3):
    """Importance-sample the env map.  Returns (dir (N,3), Le (N,3), pdf_ω).

    Uses ONE flattened (H·W+1,) CDF + binary search; u1 picks the texel,
    u2/u3 jitter within it (a marginal/conditional pair would need a
    per-ray row gather of W+1 floats — gigabytes at pool scale)."""
    cdf = flat.env_flat_cdf
    pdf_tab = flat.env_pdf             # (H, W) joint pdf over [0,1]²
    h, w = pdf_tab.shape

    idx = jnp.clip(jnp.searchsorted(cdf, u1, side="right") - 1, 0, h * w - 1)
    row = idx // w
    col = idx % w
    # jitter inside the texel with two INDEPENDENT uniforms (deriving both
    # from one via fract(u·2^k) correlates the intra-texel offsets)
    j1 = u2
    j2 = u3
    u = (col.astype(jnp.float32) + j1) / w
    v = (row.astype(jnp.float32) + j2) / h

    phi = TWO_PI * u
    theta_e = PI * (v - 0.5)
    cos_e = jnp.cos(theta_e)
    direction = jnp.stack(
        [cos_e * jnp.cos(phi), jnp.sin(theta_e), cos_e * jnp.sin(phi)], axis=-1
    )

    pdf_uv = pdf_tab[row, col]
    pdf_w = pdf_uv / jnp.maximum(2.0 * PI * PI * cos_e, 1e-8)

    uv = jnp.stack([u, v], axis=-1)
    # env-map metadata as compile-time immediates (SceneStatic.tex_rows) —
    # the per-lane tex_table row gather is a tiny-table serial fusion
    eoff, ew, eh, efmt = static.tex_rows[static.env_map_id]
    le = bilinear_sample_u32_meta(
        flat.atlas_u32, eoff, ew, eh, bool(efmt), uv
    )
    return direction, le, pdf_w


def env_pdf(flat: FlatScene, static: SceneStatic, d):
    """pdf_ω of `sample_env` for arbitrary unit directions (MIS weight)."""
    from pathtracer.ops.math import sphere_to_plane

    pdf_tab = flat.env_pdf
    h, w = pdf_tab.shape
    uv = sphere_to_plane(d)
    col = jnp.clip((uv[:, 0] * w).astype(jnp.int32), 0, w - 1)
    row = jnp.clip((uv[:, 1] * h).astype(jnp.int32), 0, h - 1)
    cos_e = jnp.sqrt(jnp.maximum(1.0 - d[:, 1] * d[:, 1], 1e-8))
    return pdf_tab[row, col] / jnp.maximum(2.0 * PI * PI * cos_e, 1e-8)

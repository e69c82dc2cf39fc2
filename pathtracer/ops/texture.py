"""Texture atlas sampling.

The reference packs all textures into one device arena with per-texture
(width, height, pointer) objects and bilinear sampling
(reference: src/scene.cpp:574-597 upload, src/image.h:53-110 devTexObj /
devTexSampler).  Here the arena is channel-major (3, P) float32 (one
gather per channel) and the per-texture table is (T, 3) int32 rows
[offset, width, height]; sampling is a vectorized 4-tap gather.

Bilinear convention replicated exactly (reference: src/image.h:73-85):
  x = u * (width - 1);  lx = int(x);  ux = lx+1 if x+1 < width else lx
(i.e. clamp-to-edge, no wrap), pixel (x, y) at data[y * width + x].
Textures are stored vertically flipped at load time
(stbi_set_flip_vertically_on_load, reference: src/scene.cpp:56).
"""

from __future__ import annotations

import jax.numpy as jnp


def bilinear_sample(atlas, table, tex_id, uv):
    """Sample texture `tex_id` (..., int32) at `uv` (..., 2) → (..., 3).

    Out-of-range ids return 0 (callers mask with constant fallbacks).
    """
    tid = jnp.clip(tex_id, 0, table.shape[0] - 1)
    row = table[tid]  # (..., 3)
    offset, width, height = row[..., 0], row[..., 1], row[..., 2]

    u, v = uv[..., 0], uv[..., 1]
    x = u * (width - 1).astype(uv.dtype)
    y = v * (height - 1).astype(uv.dtype)
    lx = jnp.floor(x).astype(jnp.int32)
    ly = jnp.floor(y).astype(jnp.int32)
    ux = jnp.where(x + 1.0 >= width.astype(uv.dtype), lx, lx + 1)
    uy = jnp.where(y + 1.0 >= height.astype(uv.dtype), ly, ly + 1)
    fx = (x - jnp.floor(x))[..., None]
    fy = (y - jnp.floor(y))[..., None]

    def at(ix, iy):
        idx = offset + iy * width + ix
        idx = jnp.clip(idx, 0, atlas.shape[1] - 1)
        return jnp.stack([atlas[0][idx], atlas[1][idx], atlas[2][idx]], axis=-1)

    p1 = at(lx, ly) * (1.0 - fx) + at(ux, ly) * fx
    p2 = at(lx, uy) * (1.0 - fx) + at(ux, uy) * fx
    return p1 * (1.0 - fy) + p2 * fy


def sample_or_const(atlas, table, tex_id, const_val, uv):
    """devTexSampler semantics: texture if tex_id >= 0 else constant.

    reference: src/image.h:88-110.
    """
    tex = bilinear_sample(atlas, table, tex_id, uv)
    has_tex = (tex_id >= 0)[..., None]
    return jnp.where(has_tex, tex, const_val)


def bilinear_sample_1ch(atlas, table, tex_id, uv):
    """Channel-0 bilinear (roughness/metallic maps use .x only,
    reference: src/material.h:274,324-325) — 4 gathers instead of 12."""
    tid = jnp.clip(tex_id, 0, table.shape[0] - 1)
    row = table[tid]
    offset, width, height = row[..., 0], row[..., 1], row[..., 2]
    u, v = uv[..., 0], uv[..., 1]
    x = u * (width - 1).astype(uv.dtype)
    y = v * (height - 1).astype(uv.dtype)
    lx = jnp.floor(x).astype(jnp.int32)
    ly = jnp.floor(y).astype(jnp.int32)
    ux = jnp.where(x + 1.0 >= width.astype(uv.dtype), lx, lx + 1)
    uy = jnp.where(y + 1.0 >= height.astype(uv.dtype), ly, ly + 1)
    fx = x - jnp.floor(x)
    fy = y - jnp.floor(y)

    def at(ix, iy):
        idx = jnp.clip(offset + iy * width + ix, 0, atlas.shape[1] - 1)
        return atlas[0][idx]

    p1 = at(lx, ly) * (1.0 - fx) + at(ux, ly) * fx
    p2 = at(lx, uy) * (1.0 - fx) + at(ux, uy) * fx
    return p1 * (1.0 - fy) + p2 * fy


def sample_or_const_1ch(atlas, table, tex_id, const_val, uv):
    tex = bilinear_sample_1ch(atlas, table, tex_id, uv)
    return jnp.where(tex_id >= 0, tex, const_val)


def _bilinear_taps(table, tex_id, uv, p_max):
    tid = jnp.clip(tex_id, 0, table.shape[0] - 1)
    row = table[tid]
    offset, width, height = row[..., 0], row[..., 1], row[..., 2]
    u, v = uv[..., 0], uv[..., 1]
    x = u * (width - 1).astype(uv.dtype)
    y = v * (height - 1).astype(uv.dtype)
    lx = jnp.floor(x).astype(jnp.int32)
    ly = jnp.floor(y).astype(jnp.int32)
    ux = jnp.where(x + 1.0 >= width.astype(uv.dtype), lx, lx + 1)
    uy = jnp.where(y + 1.0 >= height.astype(uv.dtype), ly, ly + 1)
    fx = x - jnp.floor(x)
    fy = y - jnp.floor(y)
    idx = lambda ix, iy: jnp.clip(offset + iy * width + ix, 0, p_max)
    return (idx(lx, ly), idx(ux, ly), idx(lx, uy), idx(ux, uy)), fx, fy


def _unpack_rgb(v):
    r = (v & jnp.uint32(255)).astype(jnp.float32)
    g = ((v >> jnp.uint32(8)) & jnp.uint32(255)).astype(jnp.float32)
    b = ((v >> jnp.uint32(16)) & jnp.uint32(255)).astype(jnp.float32)
    return jnp.stack([r, g, b], axis=-1)


def _unpack_u32_ldr(v):
    return _unpack_rgb(v) * jnp.float32(1.0 / 255.0)


def _unpack_u32_rgbe(v):
    # RGBE decode (matches stb/read_hdr: c * 2^(e-136), 0 when e == 0)
    e = ((v >> jnp.uint32(24)) & jnp.uint32(255)).astype(jnp.int32)
    scale = jnp.where(e == 0, 0.0, jnp.exp2((e - 136).astype(jnp.float32)))
    return _unpack_rgb(v) * scale[..., None]


def _unpack_u32(v, is_rgbe):
    return jnp.where(is_rgbe[..., None], _unpack_u32_rgbe(v), _unpack_u32_ldr(v))


def bilinear_sample_u32(atlas_u32, table, tex_id, uv):
    """Bilinear over packed texels: ONE gather per tap (the float planes
    cost 3 gathers/tap; this is the sampler hot path).  LDR textures are
    8-bit RGB (lossless for PNG sources); HDR ones are RGBE (lossless vs
    the Radiance file's own encoding)."""
    (i00, i10, i01, i11), fx, fy = _bilinear_taps(table, tex_id, uv, atlas_u32.shape[0] - 1)
    tid = jnp.clip(tex_id, 0, table.shape[0] - 1)
    is_rgbe = table[tid][..., 3] == 1
    t00 = _unpack_u32(atlas_u32[i00], is_rgbe)
    t10 = _unpack_u32(atlas_u32[i10], is_rgbe)
    t01 = _unpack_u32(atlas_u32[i01], is_rgbe)
    t11 = _unpack_u32(atlas_u32[i11], is_rgbe)
    fxn = fx[..., None]
    fyn = fy[..., None]
    p1 = t00 * (1.0 - fxn) + t10 * fxn
    p2 = t01 * (1.0 - fxn) + t11 * fxn
    return p1 * (1.0 - fyn) + p2 * fyn


def sample_or_const_u32(atlas_u32, table, tex_id, const_val, uv):
    tex = bilinear_sample_u32(atlas_u32, table, tex_id, uv)
    return jnp.where((tex_id >= 0)[..., None], tex, const_val)


def bilinear_sample_u32_1ch(atlas_u32, table, tex_id, uv):
    (i00, i10, i01, i11), fx, fy = _bilinear_taps(table, tex_id, uv, atlas_u32.shape[0] - 1)
    ch = lambda v: (v & jnp.uint32(255)).astype(jnp.float32) * jnp.float32(1.0 / 255.0)
    p1 = ch(atlas_u32[i00]) * (1.0 - fx) + ch(atlas_u32[i10]) * fx
    p2 = ch(atlas_u32[i01]) * (1.0 - fx) + ch(atlas_u32[i11]) * fx
    return p1 * (1.0 - fy) + p2 * fy


def sample_or_const_u32_1ch(atlas_u32, table, tex_id, const_val, uv):
    tex = bilinear_sample_u32_1ch(atlas_u32, table, tex_id, uv)
    return jnp.where(tex_id >= 0, tex, const_val)


# ---------------------------------------------------------------------------
# static-metadata samplers: texture geometry (offset/width/height/format) is
# a compile-time fact (SceneStatic.tex_rows), so callers pass it as
# immediates (python ints folding to constants) or per-lane select chains —
# the (T, 4) tex_table row gather per lane is a tiny-table gather that
# lowers to serial strided fusions (CLAUDE.md rules 2-3).  Tap math is
# bit-identical to _bilinear_taps given equal metadata values.


def _bilinear_taps_meta(offset, width, height, uv, p_max):
    offset = jnp.asarray(offset, jnp.int32)
    width = jnp.asarray(width, jnp.int32)
    height = jnp.asarray(height, jnp.int32)
    u, v = uv[..., 0], uv[..., 1]
    x = u * (width - 1).astype(uv.dtype)
    y = v * (height - 1).astype(uv.dtype)
    lx = jnp.floor(x).astype(jnp.int32)
    ly = jnp.floor(y).astype(jnp.int32)
    ux = jnp.where(x + 1.0 >= width.astype(uv.dtype), lx, lx + 1)
    uy = jnp.where(y + 1.0 >= height.astype(uv.dtype), ly, ly + 1)
    fx = x - jnp.floor(x)
    fy = y - jnp.floor(y)
    idx = lambda ix, iy: jnp.clip(offset + iy * width + ix, 0, p_max)
    return (idx(lx, ly), idx(ux, ly), idx(lx, uy), idx(ux, uy)), fx, fy


def bilinear_sample_u32_meta(atlas_u32, offset, width, height, rgbe, uv):
    """Bilinear over packed texels with static/chained metadata.

    `rgbe` is a python bool when the format is uniform over the lanes'
    possible textures (the common case — the LDR/RGBE select and the RGBE
    exp2 fold away at trace time) or a (N,) bool array otherwise."""
    (i00, i10, i01, i11), fx, fy = _bilinear_taps_meta(
        offset, width, height, uv, atlas_u32.shape[0] - 1
    )
    if isinstance(rgbe, bool):
        unpack = _unpack_u32_rgbe if rgbe else _unpack_u32_ldr
    else:
        unpack = lambda t: _unpack_u32(t, rgbe)
    t00 = unpack(atlas_u32[i00])
    t10 = unpack(atlas_u32[i10])
    t01 = unpack(atlas_u32[i01])
    t11 = unpack(atlas_u32[i11])
    fxn = fx[..., None]
    fyn = fy[..., None]
    p1 = t00 * (1.0 - fxn) + t10 * fxn
    p2 = t01 * (1.0 - fxn) + t11 * fxn
    return p1 * (1.0 - fyn) + p2 * fyn


def bilinear_sample_u32_1ch_meta(atlas_u32, offset, width, height, uv):
    (i00, i10, i01, i11), fx, fy = _bilinear_taps_meta(
        offset, width, height, uv, atlas_u32.shape[0] - 1
    )
    ch = lambda v: (v & jnp.uint32(255)).astype(jnp.float32) * jnp.float32(1.0 / 255.0)
    p1 = ch(atlas_u32[i00]) * (1.0 - fx) + ch(atlas_u32[i10]) * fx
    p2 = ch(atlas_u32[i01]) * (1.0 - fx) + ch(atlas_u32[i11]) * fx
    return p1 * (1.0 - fy) + p2 * fy

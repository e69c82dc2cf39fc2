"""FlatScene: the device-resident SoA scene.

Replacement for the reference's `DevScene` pointer graph
(reference: src/scene.h:28-52, src/scene.cpp:569-663).  Instead of ~12
cudaMemcpys into nested device pointers, the whole scene is one pytree of
packed jnp arrays moved to device memory in a single `device_put`, laid
out for row gathers:

- triangles: one (T, 32) float32 table (v0 v1 v2 | n0 n1 n2 | uv0 uv1 uv2 |
  tangent bitangent | pad) + (T,) geom index — a leaf hit is ONE row gather
- BVH nodes: (D*N, 8) float32 [bmin bmax pad] + (D*N, 4) int32
  [start end hit miss] — one traversal step is two row gathers
- materials: (M, 8) float32 + (M, 8) int32 tables
- all textures packed in a single (P, 3) atlas + (Ntex, 3) [offset w h] table
  (mirroring dev_texture_data/devTexObj, reference: src/scene.cpp:574-597)

Build-time work replicated from Scene::setDevData (reference:
src/scene.cpp:479-563): world-space triangle baking with per-triangle
tangent/bitangent from UVs, light-primitive gathering (geom lights first,
then per-triangle emissive lights in post-BVH order), and the env-map
luminance·sin(θ) distribution (which we extend to a true 2D CDF for optional
importance sampling — the reference builds a 1D CDF it never samples,
reference: src/scene.cpp:514-529, README.md:25-27).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

import jax.numpy as jnp

from pathtracer.accel.bvh import FlatBVH, build_bvh
from pathtracer.scene.parser import LIGHT, OBJ, SceneData

TRI_ROW = 32  # packed triangle row width


class FlatScene(NamedTuple):
    """Traced pytree of device arrays (dynamic data only)."""

    # geoms (padded to >=1)
    geom_type: jnp.ndarray        # (G,) int32: 0 sphere, 1 cube, 2 obj
    geom_mat: jnp.ndarray         # (G,) int32
    geom_transform: jnp.ndarray   # (G, 4, 4) float32
    geom_inv: jnp.ndarray         # (G, 4, 4)
    geom_invt: jnp.ndarray        # (G, 4, 4)
    # triangles
    tri_data: jnp.ndarray         # (T, 32) float32
    tri_geom: jnp.ndarray         # (T,) int32
    # BVH — threaded MTBVH (both walks, ops/traverse.py)
    bvh_f32: jnp.ndarray          # (D*N, 8) float32: bmin(3) bmax(3) pad(2)
    bvh_i32: jnp.ndarray          # (D*N, 4) int32: start end hit miss
    # materials — component-major (8, M): one (N,) gather per component
    mat_f32: jnp.ndarray          # (8, M): albedo(3) roughness metallic ior pad(2)
    mat_i32: jnp.ndarray          # (8, M): type atex mtex rtex ntex pad(3)
    # textures
    atlas: jnp.ndarray            # (3, P) float32 channel planes (HDR/env)
    atlas_u32: jnp.ndarray        # (P,) uint32 packed 8-bit RGB — material
    # samplers use this (1 gather per tap instead of 3; lossless for the
    # 8-bit LDR sources the reference loads, src/image.cpp:22-38)
    tex_table: jnp.ndarray        # (Ntex, 4) int32: offset width height format(0=rgb8,1=rgbe)
    # lights
    light_geom: jnp.ndarray       # (L,) int32
    light_tri: jnp.ndarray        # (L,) int32  (-1 for analytic geoms)
    light_type: jnp.ndarray       # (L,) int32
    # environment importance CDF (all-zero when unused): the joint
    # luminance·sinθ distribution flattened to ONE (H·W+1,) CDF — the
    # same 1D-over-all-pixels design as the reference's Distribution1D
    # (reference: src/scene.cpp:514-529); a marginal/conditional pair
    # needed a (N, W+1) row gather per sample (gigabytes at 640k rays)
    env_flat_cdf: jnp.ndarray         # (H*W+1,) float32
    env_pdf: jnp.ndarray              # (H, W) float32 joint pdf over [0,1]²


@dataclass(frozen=True)
class SceneStatic:
    """Hashable compile-time facts about the scene (jit static arg)."""

    geom_types: tuple  # per-geom type codes (static → type-specialized tests)
    geom_mats: tuple   # per-geom material ids (static → select-chain lookup)
    geom_mat_types: tuple  # per-geom material TYPE codes (static → light
    # emission chains select only over light-material geoms)
    material_types: tuple  # sorted set of material types present (static →
    # absent BSDF lobes are never evaluated)
    mat_rows_f: tuple  # per-material (r, g, b, roughness, metallic, ior)
    # as STATIC python floats — material params are compile-time facts, so
    # the per-ray select chains embed them as immediates and dedupe by
    # VALUE (a component equal across materials compiles to one select or
    # none), instead of reading traced table scalars per material
    mat_rows_i: tuple  # per-material (type, atex, mtex, rtex, ntex) static
    scene_bounds: tuple  # (bmin xyz, bmax xyz) of ALL geometry — the ray
    # sort's spatial hash grid (the BVH root covers triangles only)
    analytic_lights: tuple  # (light_idx, geom_idx, geom_type) for non-OBJ lights
    max_prim: int     # binary-tree leaf capacity (walk unroll factor;
    # reference: src/BVH.h:5 MAX_PRIM)
    num_geoms: int
    num_tris: int
    num_bvh_nodes: int
    num_bvh_trees: int
    num_lights: int
    num_materials: int
    env_map_id: int       # -1 = no environment map
    has_textures: bool
    tex_slots: tuple      # (albedo, metallic, roughness, normal) — whether
    # ANY material carries that map (static → absent samplers skip their
    # 4-12 atlas gathers per bounce)
    tex_rows: tuple       # per-texture (offset, width, height, format) as
    # STATIC python ints — texture geometry is a compile-time fact, so
    # samplers chain the metadata as immediates instead of row-gathering
    # flat.tex_table per lane
    width: int
    height: int
    trace_depth: int
    iterations: int
    image_name: str


def _pack_triangles(
    scene: SceneData,
    vertex_normal: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """World-space bake + TBN (reference: src/scene.cpp:481-512).

    `vertex_normal=False` forces FACE normals even when the OBJ carries
    vertex normals (the reference's VERTEX_NORMAL=0 compile branch,
    reference: src/scene.cpp:395-411, src/utilities.h:26)."""
    rows = []
    geom_ids = []
    for gi, g in enumerate(scene.geoms):
        if g.type != OBJ or g.mesh_key is None:
            continue
        mesh = scene.meshes[g.mesh_key]
        v = mesh["positions"]           # (T,3,3) object space
        n = mesh["normals"]
        if not vertex_normal:
            fn = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])
            ln = np.linalg.norm(fn, axis=-1, keepdims=True)
            fn = np.where(ln > 0, fn / np.maximum(ln, 1e-38), fn)
            n = np.repeat(fn[:, None, :], 3, axis=1)
        uv = mesh["uvs"]
        T = v.shape[0]
        if T == 0:
            continue
        m = g.transform.astype(np.float64)
        it = g.inv_transpose.astype(np.float64)
        vw = np.einsum("ij,tcj->tci", m[:3, :3], v.astype(np.float64)) + m[:3, 3]
        nw = np.einsum("ij,tcj->tci", it[:3, :3], n.astype(np.float64))
        nlen = np.linalg.norm(nw, axis=-1, keepdims=True)
        nw = np.where(nlen > 0, nw / np.maximum(nlen, 1e-38), nw)

        e1 = vw[:, 1] - vw[:, 0]
        e2 = vw[:, 2] - vw[:, 0]
        duv1 = uv[:, 1] - uv[:, 0]
        duv2 = uv[:, 2] - uv[:, 0]
        f = duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]
        ok = np.abs(f) >= 1e-8
        fsafe = np.where(ok, f, 1.0)
        tan = (duv2[:, 1:2] * e1 - duv1[:, 1:2] * e2) / fsafe[:, None]
        bit = (-duv2[:, 0:1] * e1 + duv1[:, 0:1] * e2) / fsafe[:, None]

        def _norm(x):
            ln = np.linalg.norm(x, axis=-1, keepdims=True)
            return np.where(ln > 0, x / np.maximum(ln, 1e-38), x)

        tan = np.where(ok[:, None], _norm(tan), 0.0)
        bit = np.where(ok[:, None], _norm(bit), 0.0)

        row = np.zeros((T, TRI_ROW), np.float32)
        row[:, 0:9] = vw.reshape(T, 9)
        row[:, 9:18] = nw.reshape(T, 9)
        row[:, 18:24] = uv.reshape(T, 6)
        row[:, 24:27] = tan
        row[:, 27:30] = bit
        # geom id rides the row (col 30, exact in f32 below 2^24): closest_hit
        # reads it from the already-gathered row instead of a separate
        # tri_geom[tidx] gather
        row[:, 30] = gi
        rows.append(row)
        geom_ids.append(np.full(T, gi, np.int32))

    if rows:
        return np.concatenate(rows, axis=0), np.concatenate(geom_ids)
    return np.zeros((0, TRI_ROW), np.float32), np.zeros((0,), np.int32)


def _pack_textures(scene: SceneData):
    if not scene.textures:
        return (
            np.zeros((3, 1), np.float32),
            np.zeros((1,), np.uint32),
            np.zeros((1, 4), np.int32),
        )
    table = []
    chunks = []
    offset = 0
    for img in scene.textures:
        h, w, _ = img.shape
        table.append((offset, w, h))
        chunks.append(img.reshape(-1, 3))
        offset += w * h
    flat = np.concatenate(chunks, axis=0).astype(np.float32)
    # LDR texels pack as plain 8-bit RGB (lossless for PNG sources); HDR
    # texels pack as RGBE with a shared exponent — lossless vs the .hdr
    # FILE (Radiance stores 8-bit mantissas + exponent), though slightly
    # quantized vs the float planes' bilinear of decoded values
    fmt = []
    packed = np.zeros(flat.shape[0], np.uint32)
    pos = 0
    for k, img in enumerate(scene.textures):
        n = img.shape[0] * img.shape[1]
        chunk = flat[pos : pos + n]
        if chunk.max() > 1.0:  # HDR → RGBE
            maxc = chunk.max(axis=-1)
            with np.errstate(divide="ignore"):
                e = np.where(maxc > 1e-32, np.floor(np.log2(maxc)) + 1, 0).astype(np.int32)
            scale = np.where(maxc > 1e-32, np.ldexp(1.0, -e) * 256.0, 0.0)
            q = np.clip(chunk * scale[:, None], 0, 255).astype(np.uint32)
            eb = np.where(maxc > 1e-32, e + 128, 0).astype(np.uint32)
            packed[pos : pos + n] = q[:, 0] | (q[:, 1] << 8) | (q[:, 2] << 16) | (eb << 24)
            fmt.append(1)
        else:
            q = np.clip(chunk * 255.0 + 0.5, 0, 255).astype(np.uint32)
            packed[pos : pos + n] = q[:, 0] | (q[:, 1] << 8) | (q[:, 2] << 16)
            fmt.append(0)
        pos += n
    table = [(o, w, h, f) for (o, w, h), f in zip(table, fmt)]
    return flat.T.copy(), packed, np.asarray(table, np.int32)


def _env_cdfs(scene: SceneData) -> tuple[np.ndarray, np.ndarray]:
    """2D luminance·sin(θ) CDFs for env importance sampling.

    Row weighting matches the reference's CDF input
    (reference: src/scene.cpp:519-525): lum(pixel) · sin((0.5+i)/H · π).
    """
    if scene.env_map_id < 0:
        return np.zeros((1,), np.float32), np.zeros((1, 1), np.float32)
    img = scene.textures[scene.env_map_id]
    h, w, _ = img.shape
    lum = 0.2126 * img[..., 0] + 0.7152 * img[..., 1] + 0.0722 * img[..., 2]
    sin_t = np.sin((0.5 + np.arange(h)) / h * np.pi)
    f = (lum * sin_t[:, None]).astype(np.float64)
    flat_cdf = np.zeros(h * w + 1, np.float64)
    np.cumsum(f.reshape(-1), out=flat_cdf[1:])
    total = flat_cdf[-1] if flat_cdf[-1] > 0 else 1.0
    flat_cdf /= total
    # joint pdf over [0,1]²: f / mean(f)
    mean_f = f.mean() if f.mean() > 0 else 1.0
    pdf = (f / mean_f).astype(np.float32)
    return flat_cdf.astype(np.float32), pdf


def _scene_bounds(scene: SceneData, bvh: FlatBVH) -> tuple:
    """Conservative world bounds of all geometry (unit shapes span ±0.5)."""
    lo = np.full(3, np.inf)
    hi = np.full(3, -np.inf)
    for g in scene.geoms:
        if g.type == OBJ:
            continue
        c = g.transform[:3, 3]
        ext = np.abs(g.transform[:3, :3]).sum(axis=1) * 0.5
        lo = np.minimum(lo, c - ext)
        hi = np.maximum(hi, c + ext)
    if bvh.num_nodes > 0:
        lo = np.minimum(lo, bvh.bbox_min[0])
        hi = np.maximum(hi, bvh.bbox_max[0])
    if not np.isfinite(lo).all():
        lo = np.zeros(3)
        hi = np.ones(3)
    return tuple(float(x) for x in lo) + tuple(float(x) for x in hi)


def build_flat_scene(
    scene: SceneData, opts=None
) -> tuple[FlatScene, SceneStatic]:
    """`opts` (utils/config.RenderOptions) wires the reference's
    compile-time build knobs: use_sah/use_mtbvh/max_prim/bucket_num
    (reference: src/utilities.h:23-24, src/BVH.h:5-6) and vertex_normal
    (src/utilities.h:26)."""
    use_sah = opts.use_sah if opts is not None else True
    use_mtbvh = opts.use_mtbvh if opts is not None else True
    max_prim = opts.max_prim if opts is not None else 1
    bucket_num = opts.bucket_num if opts is not None else 20
    vertex_normal = opts.vertex_normal if opts is not None else True
    # geoms (pad to at least 1 so gathers are valid)
    G = max(len(scene.geoms), 1)
    geom_type = np.full(G, -1, np.int32)
    geom_mat = np.zeros(G, np.int32)
    xf = np.tile(np.eye(4, dtype=np.float32), (G, 1, 1))
    inv = xf.copy()
    invt = xf.copy()
    for i, g in enumerate(scene.geoms):
        geom_type[i] = g.type
        geom_mat[i] = g.material_id
        xf[i] = g.transform
        inv[i] = g.inverse_transform
        invt[i] = g.inv_transpose

    tri_data, tri_geom = _pack_triangles(scene, vertex_normal=vertex_normal)

    bvh: FlatBVH = build_bvh(
        tri_data[:, 0:9].reshape(-1, 3, 3) if tri_data.shape[0] else tri_data.reshape(0, 3, 3),
        use_sah=use_sah,
        mtbvh=use_mtbvh,
        max_prim=max_prim,
        bucket_num=bucket_num,
    )
    if tri_data.shape[0]:
        tri_data = tri_data[bvh.order]
        tri_geom = tri_geom[bvh.order]

    # materials
    M = max(len(scene.materials), 1)
    mat_f32 = np.zeros((M, 8), np.float32)
    mat_i32 = np.full((M, 8), -1, np.int32)
    for i, m in enumerate(scene.materials):
        mat_f32[i, 0:3] = m.albedo
        mat_f32[i, 3] = m.roughness
        mat_f32[i, 4] = m.metallic
        mat_f32[i, 5] = m.ior
        mat_i32[i, 0] = m.type
        mat_i32[i, 1] = m.albedo_tex
        mat_i32[i, 2] = m.metallic_tex
        mat_i32[i, 3] = m.roughness_tex
        mat_i32[i, 4] = m.normal_tex

    atlas, atlas_u32, tex_table = _pack_textures(scene)

    # lights: analytic geoms first, then emissive triangles in post-BVH order
    # (reference: src/scene.cpp:538-558)
    lg, lt, lty = [], [], []
    for i, g in enumerate(scene.geoms):
        if (
            0 <= g.material_id < len(scene.materials)
            and scene.materials[g.material_id].type == LIGHT
            and g.type != OBJ
        ):
            lg.append(i)
            lt.append(-1)
            lty.append(g.type)
    for ti in range(tri_data.shape[0]):
        gi = int(tri_geom[ti])
        mid = int(geom_mat[gi])
        if 0 <= mid < len(scene.materials) and scene.materials[mid].type == LIGHT:
            lg.append(gi)
            lt.append(ti)
            lty.append(OBJ)
    L = max(len(lg), 1)
    light_geom = np.zeros(L, np.int32)
    light_tri = np.full(L, -1, np.int32)
    light_type = np.full(L, -1, np.int32)
    light_geom[: len(lg)] = lg
    light_tri[: len(lg)] = lt
    light_type[: len(lg)] = lty

    env_cdf_flat, env_pdf_tab = _env_cdfs(scene)

    # pad triangle/bvh arrays to >=1 row so device gathers are shape-valid
    if tri_data.shape[0] == 0:
        tri_data = np.zeros((1, TRI_ROW), np.float32)
        tri_geom = np.zeros((1,), np.int32)
    bvh_f32 = np.zeros((max(bvh.bbox_min.shape[0], 1), 8), np.float32)
    bvh_i32 = np.zeros((max(bvh.bbox_min.shape[0], 1), 4), np.int32)
    if bvh.bbox_min.shape[0]:
        bvh_f32[:, 0:3] = bvh.bbox_min
        bvh_f32[:, 3:6] = bvh.bbox_max
        bvh_i32[:, 0] = bvh.start
        bvh_i32[:, 1] = bvh.end
        bvh_i32[:, 2] = bvh.hit
        bvh_i32[:, 3] = bvh.miss
    flat = FlatScene(
        geom_type=jnp.asarray(geom_type),
        geom_mat=jnp.asarray(geom_mat),
        geom_transform=jnp.asarray(xf),
        geom_inv=jnp.asarray(inv),
        geom_invt=jnp.asarray(invt),
        tri_data=jnp.asarray(tri_data),
        tri_geom=jnp.asarray(tri_geom),
        bvh_f32=jnp.asarray(bvh_f32),
        bvh_i32=jnp.asarray(bvh_i32),
        mat_f32=jnp.asarray(mat_f32.T.copy()),
        mat_i32=jnp.asarray(mat_i32.T.copy()),
        atlas=jnp.asarray(atlas),
        atlas_u32=jnp.asarray(atlas_u32),
        tex_table=jnp.asarray(tex_table),
        light_geom=jnp.asarray(light_geom),
        light_tri=jnp.asarray(light_tri),
        light_type=jnp.asarray(light_type),
        env_flat_cdf=jnp.asarray(env_cdf_flat),
        env_pdf=jnp.asarray(env_pdf_tab),
    )
    static = SceneStatic(
        geom_types=tuple(int(g.type) for g in scene.geoms),
        geom_mats=tuple(int(g.material_id) for g in scene.geoms),
        geom_mat_types=tuple(
            int(scene.materials[g.material_id].type)
            if 0 <= g.material_id < len(scene.materials) else -1
            for g in scene.geoms
        ),
        material_types=tuple(sorted({int(m.type) for m in scene.materials})),
        mat_rows_f=tuple(
            tuple(float(v) for v in mat_f32[i, 0:6])
            for i in range(len(scene.materials))
        ),
        mat_rows_i=tuple(
            tuple(int(v) for v in mat_i32[i, 0:5])
            for i in range(len(scene.materials))
        ),
        scene_bounds=_scene_bounds(scene, bvh),
        analytic_lights=tuple(
            (li, int(lg[li]), int(lty[li]))
            for li in range(len(lg))
            if lt[li] < 0
        ),
        max_prim=max_prim,
        num_geoms=len(scene.geoms),
        num_tris=int(bvh.order.shape[0]),
        num_bvh_nodes=bvh.num_nodes,
        num_bvh_trees=bvh.num_trees,
        num_lights=len(lg),
        num_materials=len(scene.materials),
        env_map_id=scene.env_map_id,
        has_textures=len(scene.textures) > 0,
        tex_slots=(
            any(m.albedo_tex >= 0 for m in scene.materials),
            any(m.metallic_tex >= 0 for m in scene.materials),
            any(m.roughness_tex >= 0 for m in scene.materials),
            any(m.normal_tex >= 0 for m in scene.materials),
        ),
        tex_rows=tuple(
            tuple(int(v) for v in row) for row in np.asarray(tex_table)
        ),
        width=scene.camera.resolution[0],
        height=scene.camera.resolution[1],
        trace_depth=scene.trace_depth,
        iterations=scene.iterations,
        image_name=scene.image_name,
    )
    return flat, static

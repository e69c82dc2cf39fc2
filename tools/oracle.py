"""Independent end-to-end oracle: a numpy port of the reference CUDA
path tracer's kernel semantics, sharing NO code with pathtracer.

Purpose (VERDICT round 2, "Missing #1"): every test in tests/ checks the
framework against formula ports written by the same build; this module is
a second, whole-image implementation ported line-by-line from the CUDA
sources so a shared misreading of the reference would show up as an
RMSE gap.  It is deliberately slow-and-simple: flat numpy over a ray
pool, brute-force analytic geoms, cluster-grid triangles, no BVH, no JAX.

Ported semantics (every function cites its source):
  - camera/ray gen        reference: src/pathtrace.cu:135-163, main.cpp:106-127,172-190
  - intersections         reference: src/intersections.h:48-144, src/Bounds3.hpp:298-326
  - wavefront + modes     reference: src/pathtrace.cu:348-588,637-797
  - materials             reference: src/material.h:40-114,246-357,450-521
  - sampling/math         reference: src/utilities.h:188-442
  - NEE / light PDFs      reference: src/lightSample.h:59-248
  - scene text format     reference: src/scene.cpp:47-337, src/utilities.cpp:65-72
  - world-space tri bake  reference: src/scene.cpp:479-512
  - tonemap/save          reference: src/utilities.h:35-48, src/main.cpp:146-170

The RNG is numpy PCG64 (the reference uses thrust engines); parity is
statistical — matched images at matched spp agree to the MC noise floor.

Intentionally replicated reference quirks (same list as PARITY.md):
  roughness-as-alpha^2 SmithG (material.h:256,269), sphere lights assumed
  radius 0.5 ignoring scale (lightSample.h:163,216), cube lights have no
  NEE branch (lightSample.h:186-234), power heuristic fed pdf=-1
  (pathtrace.cu:550), theta=degrees(sin(view.y)) camera (main.cpp:113),
  tan(full-FOVY) pixelLength (scene.cpp:219-227), object-space 1e-4 ray
  pull-back (intersections.h:27), save-time X mirror (main.cpp:158).
"""

from __future__ import annotations

import math as _m
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

PI = _m.pi
TWO_PI = 2.0 * _m.pi
INV_PI = 1.0 / _m.pi
ROUGHNESS_MIN = 1e-3  # reference: src/utilities.h:28
ROUGHNESS_MAX = 1.0   # reference: src/utilities.h:29

# Material::Type (reference: src/material.h:31-37)
LAMBERTIAN, METALLIC_WORKFLOW, DIELECTRIC, MICROFACET, LIGHT = range(5)
# GeomType (reference: src/sceneStructs.h:11-15)
SPHERE, CUBE, OBJ = range(3)


# --------------------------------------------------------------------------
# scene loading (independent minimal parser for the reference text format)
# --------------------------------------------------------------------------

@dataclass
class OMaterial:
    type: int = LAMBERTIAN
    albedo: np.ndarray = field(default_factory=lambda: np.ones(3))
    metallic: float = 0.0
    roughness: float = 0.0
    ior: float = 1.5
    # texture-or-constant fields (reference: src/scene.cpp:275-306 tries
    # each material property as a texture path first; src/image.h:88-110
    # devTexSampler falls back to the constant).  Each map is a float
    # (H, W, 3) array or None.
    albedo_map: np.ndarray | None = None
    metallic_map: np.ndarray | None = None
    roughness_map: np.ndarray | None = None
    normal_map: np.ndarray | None = None


@dataclass
class OGeom:
    type: int
    material: int
    transform: np.ndarray      # (4,4)
    inv: np.ndarray
    invt: np.ndarray


@dataclass
class OScene:
    materials: list
    geoms: list
    # world-space triangles (reference: src/scene.cpp:481-512)
    tri_v: np.ndarray          # (T, 3, 3)
    tri_n: np.ndarray          # (T, 3, 3)
    tri_geom: np.ndarray       # (T,)
    tri_uv: np.ndarray         # (T, 3, 2) vertex texcoords
    tri_tan: np.ndarray        # (T, 3) per-triangle world tangent
    #                            (reference: src/scene.cpp:495-508)
    env_map: np.ndarray | None # (H, W, 3) or None (reference: scene.cpp:76)
    lights: list               # [(geomID, triangleID, gtype)]
    cam_position: np.ndarray
    cam_view: np.ndarray
    cam_up: np.ndarray
    cam_right: np.ndarray
    pixel_length: np.ndarray   # (2,)
    resolution: tuple
    trace_depth: int
    iterations: int
    fovy: float = 45.0         # kept so render() can redo pixelLength
    # when width/height override the scene resolution
    # (reference: src/scene.cpp:219-227)
    # triangle cluster accel (oracle-only speedup; exact same hit set
    # as the brute-force loop at src/pathtrace.cu:281-296)
    cl_lo: np.ndarray = None   # (C, 3)
    cl_hi: np.ndarray = None
    cl_start: np.ndarray = None
    cl_end: np.ndarray = None


def _build_transform(trans, rot, scale) -> np.ndarray:
    """translate * rotX * rotY * rotZ * scale
    (reference: src/utilities.cpp:65-72)."""
    t = np.eye(4)
    t[:3, 3] = trans
    def _rot(axis, deg):
        r = _m.radians(deg)
        c, s = _m.cos(r), _m.sin(r)
        m = np.eye(4)
        i, j = [(1, 2), (0, 2), (0, 1)][axis]
        m[i, i] = c
        m[j, j] = c
        if axis == 1:
            m[i, j] = s
            m[j, i] = -s
        else:
            m[i, j] = -s
            m[j, i] = s
        return m
    rx, ry, rz = (_rot(a, rot[a]) for a in range(3))
    sc = np.diag([scale[0], scale[1], scale[2], 1.0])
    return t @ rx @ ry @ rz @ sc


def _atof(s: str) -> float:
    """C atof: parse a leading float prefix, 0.0 when none (the
    reference's texture-or-constant fallback, src/scene.cpp:275-306)."""
    import re

    m = re.match(r"\s*[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?", s)
    return float(m.group(0)) if m else 0.0


def _resolve_asset(tok: str, base: Path) -> str | None:
    """Normalize Windows separators and probe the same roots the geom
    loader does; None when the file doesn't exist."""
    nrm = tok.replace("\\", "/")
    cands = [Path(nrm), base / nrm, base.parent / nrm]
    if nrm.startswith("../"):
        cands.append(base.parent / nrm[3:])
    name = Path(nrm).name
    cands += [base / "model" / name, base / "texture" / name,
              base / "env" / name]
    return next((str(c) for c in cands if c.is_file()), None)


def _read_rgbe(path: str) -> np.ndarray:
    """Independent Radiance RGBE (.hdr) decoder → float (H, W, 3).
    Written against the format spec (new-style RLE scanlines), sharing
    no code with pathtracer.utils.image_io."""
    raw = Path(path).read_bytes()
    # header ends at the first blank line; next line is the size spec
    pos = raw.find(b"\n\n")
    if pos < 0:
        raise ValueError("bad RGBE header")
    nl = raw.find(b"\n", pos + 2)
    size = raw[pos + 2: nl].split()
    if size[0] != b"-Y" or size[2] != b"+X":
        raise ValueError(f"unsupported RGBE orientation {size}")
    H, W = int(size[1]), int(size[3])
    data = np.frombuffer(raw[nl + 1:], np.uint8)
    out = np.zeros((H, W, 4), np.uint8)
    p = 0
    for y in range(H):
        # new-style RLE scanline: 0x02 0x02 hi lo then 4 RLE channels
        if W >= 8 and W < 32768 and data[p] == 2 and data[p + 1] == 2 \
                and (int(data[p + 2]) << 8 | int(data[p + 3])) == W:
            p += 4
            for c in range(4):
                x = 0
                while x < W:
                    n = int(data[p]); p += 1
                    if n > 128:  # run
                        out[y, x: x + n - 128, c] = data[p]
                        p += 1
                        x += n - 128
                    else:  # literal
                        out[y, x: x + n, c] = data[p: p + n]
                        p += n
                        x += n
        else:  # flat RGBE pixels
            row = data[p: p + 4 * W].reshape(W, 4)
            out[y] = row
            p += 4 * W
    e = out[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0)
    return out[..., :3].astype(np.float64) * scale[..., None]


def _load_texture_file(path: str, gamma: float = 1.0) -> np.ndarray:
    """Float (H, W, 3) texture, flipped vertically like
    stbi_set_flip_vertically_on_load(true) (reference: src/scene.cpp:56);
    LDR promoted with the reference's default gamma 1.0
    (reference: src/image.cpp:22-38, src/scene.h:60)."""
    if path.lower().endswith(".hdr"):
        img = _read_rgbe(path)
    else:
        from PIL import Image

        with Image.open(path) as im:
            arr = np.asarray(im.convert("RGB"), np.float64) / 255.0
        img = arr ** gamma if gamma != 1.0 else arr
    return img[::-1].copy()


def bilinear_sample(img: np.ndarray, uv: np.ndarray) -> np.ndarray:
    """devTexObj::linearSample (reference: src/image.h:73-85): x scaled
    by (w-1), upper neighbour clamped at the edge, fract weights."""
    h, w = img.shape[:2]
    x = uv[..., 0] * (w - 1)
    y = uv[..., 1] * (h - 1)
    lx = x.astype(np.int64)
    ly = y.astype(np.int64)
    ux = np.where(lx + 1 >= w, lx, lx + 1)
    uy = np.where(ly + 1 >= h, ly, ly + 1)
    fx = (x - np.floor(x))[..., None]
    fy = (y - np.floor(y))[..., None]
    p1 = img[ly, lx] * (1 - fx) + img[ly, ux] * fx
    p2 = img[uy, lx] * (1 - fx) + img[uy, ux] * fx
    return p1 * (1 - fy) + p2 * fy


def sphere2plane(d: np.ndarray) -> np.ndarray:
    """Equirect direction→uv (reference: src/utilities.h:209-214)."""
    u = np.arctan2(d[..., 2], d[..., 0]) * INV_PI * 0.5 + 1.0
    u = u - np.floor(u)
    v = np.maximum(
        np.arctan2(d[..., 1], np.hypot(d[..., 0], d[..., 2])) * INV_PI + 0.5,
        0.0,
    )
    return np.stack([u, v], -1)


def _load_obj_minimal(path: str):
    """v/vn/vt/f subset with fan triangulation + vertex-normal use
    (reference: src/scene.cpp:385-411 via tiny_obj_loader)."""
    vs, vns, vts = [], [], []
    faces = []
    for line in Path(path).read_text(errors="replace").splitlines():
        tk = line.split()
        if not tk:
            continue
        if tk[0] == "v":
            vs.append([float(x) for x in tk[1:4]])
        elif tk[0] == "vn":
            vns.append([float(x) for x in tk[1:4]])
        elif tk[0] == "vt":
            vts.append([float(x) for x in tk[1:3]])
        elif tk[0] == "f":
            corners = []
            for c in tk[1:]:
                parts = c.split("/")
                vi = int(parts[0])
                ti = int(parts[1]) if len(parts) > 1 and parts[1] else 0
                ni = int(parts[2]) if len(parts) > 2 and parts[2] else 0
                corners.append((vi, ni, ti))
            for k in range(len(corners) - 2):
                faces.append([corners[0], corners[k + 1], corners[k + 2]])
    vs = np.asarray(vs)
    vns = np.asarray(vns) if vns else np.zeros((0, 3))
    vts = np.asarray(vts) if vts else np.zeros((0, 2))
    tv = np.zeros((len(faces), 3, 3))
    tn = np.zeros((len(faces), 3, 3))
    tu = np.zeros((len(faces), 3, 2))
    for fi, face in enumerate(faces):
        for ci, (vi, ni, ti) in enumerate(face):
            tv[fi, ci] = vs[vi - 1 if vi > 0 else len(vs) + vi]
        e1 = tv[fi, 1] - tv[fi, 0]
        e2 = tv[fi, 2] - tv[fi, 0]
        fn = np.cross(e1, e2)
        fn /= max(np.linalg.norm(fn), 1e-38)
        for ci, (vi, ni, ti) in enumerate(face):
            if ni != 0 and len(vns):
                tn[fi, ci] = vns[ni - 1 if ni > 0 else len(vns) + ni]
            else:
                tn[fi, ci] = fn
            if ti != 0 and len(vts):
                tu[fi, ci] = vts[ti - 1 if ti > 0 else len(vts) + ti]
    return tv, tn, tu


def load_scene(path: str | Path) -> OScene:
    """reference: src/scene.cpp:47-337 (MATERIAL/OBJECT/CAMERA blocks)."""
    lines = Path(path).read_text().splitlines()
    mats: list[OMaterial] = []
    mat_names: dict[str, int] = {}
    geoms: list[OGeom] = []
    tri_v, tri_n, tri_geom, tri_uv, tri_tan = [], [], [], [], []
    env_map = None
    tex_cache: dict[str, np.ndarray] = {}
    cam = {}
    i = 0

    def _try_texture(tok: str) -> np.ndarray | None:
        """reference: src/scene.cpp:318-337 loadTexture (None on failure,
        pooled by filename like Resource::texturePool)."""
        p = _resolve_asset(tok, base)
        if p is None:
            return None
        if p not in tex_cache:
            try:
                tex_cache[p] = _load_texture_file(p)
            except Exception:
                return None
        return tex_cache[p]
    type_map = {
        "Lambertian": LAMBERTIAN, "MetallicWorkflow": METALLIC_WORKFLOW,
        "Dielectric": DIELECTRIC, "Microfacet": MICROFACET, "Light": LIGHT,
    }  # reference: src/scene.cpp:12-18
    base = Path(path).parent

    def tok(s):
        return s.split("//")[0].split() if not s.strip().startswith("//") else []

    while i < len(lines):
        tk = tok(lines[i])
        if not tk:
            i += 1
            continue
        if tk[0] == "MATERIAL":
            name = tk[1]
            m = OMaterial()
            i += 1
            # exactly 6 property lines read (reference: src/scene.cpp:258)
            for _ in range(6):
                if i >= len(lines):
                    break
                ptk = tok(lines[i])
                if not ptk:
                    break
                key = ptk[0]
                # every property is texture-or-constant: tried as a
                # texture path first, atof fallback on failure
                # (reference: src/scene.cpp:275-306)
                if key == "TYPE":
                    m.type = type_map[ptk[1]]
                elif key == "ALBEDO":
                    m.albedo_map = _try_texture(ptk[1])
                    if m.albedo_map is None:
                        vals = [_atof(x) for x in ptk[1:4]]
                        vals += [0.0] * (3 - len(vals))
                        m.albedo = np.array(vals)
                elif key == "METALLIC":
                    m.metallic_map = _try_texture(ptk[1])
                    if m.metallic_map is None:
                        m.metallic = _atof(ptk[1])
                elif key == "ROUGHNESS":
                    m.roughness_map = _try_texture(ptk[1])
                    if m.roughness_map is None:
                        # load-time floor (reference: src/scene.cpp:295)
                        m.roughness = max(_atof(ptk[1]), ROUGHNESS_MIN)
                elif key == "IOR":
                    m.ior = _atof(ptk[1])
                elif key == "NORMAL":
                    # no map → constant (0.5,0.5,1) ⇒ identity
                    # (reference: src/scene.cpp:300-306)
                    m.normal_map = _try_texture(ptk[1])
                else:
                    break
                i += 1
            mat_names[name] = len(mats)
            mats.append(m)
            continue
        if tk[0] == "OBJECT":
            i += 1
            tline = tok(lines[i])[0]
            if tline == "sphere":
                gtype = SPHERE
            elif tline == "cube":
                gtype = CUBE
            else:
                gtype = OBJ
                # normalise Windows separators and probe the same roots the
                # framework parser does (scene/parser.py _resolve_asset);
                # missing OBJ ⇒ warn + keep the geom meshless, matching the
                # framework (reference: src/scene.cpp:116 stores a null mesh)
                nrm_tok = tline.replace("\\", "/")
                cands = [Path(nrm_tok), base / nrm_tok, base.parent / nrm_tok]
                if nrm_tok.startswith("../"):
                    cands.append(base.parent / nrm_tok[3:])
                cands.append(base / "model" / Path(nrm_tok).name)
                objpath = next((str(c) for c in cands if c.is_file()), None)
            i += 1
            mtk = tok(lines[i])
            mid = mat_names.get(mtk[1], None)
            if mid is None:
                mid = int(mtk[1])
            i += 1
            trans = rot = np.zeros(3)
            scale = np.ones(3)
            while i < len(lines):
                ptk = tok(lines[i])
                if not ptk:
                    break
                if ptk[0] == "TRANS":
                    trans = np.array([float(x) for x in ptk[1:4]])
                elif ptk[0] == "ROTAT":
                    rot = np.array([float(x) for x in ptk[1:4]])
                elif ptk[0] == "SCALE":
                    scale = np.array([float(x) for x in ptk[1:4]])
                else:
                    break
                i += 1
            xf = _build_transform(trans, rot, scale)
            g = OGeom(gtype, mid, xf, np.linalg.inv(xf),
                      np.linalg.inv(xf).T)
            gi = len(geoms)
            geoms.append(g)
            if gtype == OBJ and objpath is None:
                import warnings

                warnings.warn(f"OBJ not found, skipping mesh: {tline}")
            elif gtype == OBJ:
                tv, tn, tu = _load_obj_minimal(objpath)
                # world bake (reference: src/scene.cpp:489-493)
                tvw = tv @ xf[:3, :3].T + xf[:3, 3]
                tnw = tn @ g.invt[:3, :3].T
                tnw /= np.maximum(
                    np.linalg.norm(tnw, axis=-1, keepdims=True), 1e-38
                )
                # per-triangle world tangent from UV deltas; zero when
                # the UV area is degenerate (reference: src/scene.cpp:495-508)
                e1 = tvw[:, 1] - tvw[:, 0]
                e2 = tvw[:, 2] - tvw[:, 0]
                d1 = tu[:, 1] - tu[:, 0]
                d2 = tu[:, 2] - tu[:, 0]
                f = d1[:, 0] * d2[:, 1] - d2[:, 0] * d1[:, 1]
                fs = np.where(np.abs(f) < 1e-8, 1.0, f)[:, None]
                tan = (d2[:, 1, None] * e1 - d1[:, 1, None] * e2) / fs
                tan = np.where(
                    np.abs(f)[:, None] < 1e-8, 0.0,
                    tan / np.maximum(
                        np.linalg.norm(tan, axis=-1, keepdims=True), 1e-38
                    ),
                )
                tri_v.append(tvw)
                tri_n.append(tnw)
                tri_uv.append(tu)
                tri_tan.append(tan)
                tri_geom.append(np.full(len(tvw), gi, np.int64))
            continue
        if tk[0] == "ENV":
            # reference: src/scene.cpp:74-79 (HDR env map via loadTexture)
            env_map = _try_texture(tk[1])
            i += 1
            continue
        if tk[0] == "CAMERA":
            i += 1
            # 5 static lines (reference: src/scene.cpp:172-192)
            for _ in range(5):
                ptk = tok(lines[i])
                cam[ptk[0]] = ptk[1:]
                i += 1
            while i < len(lines):
                ptk = tok(lines[i])
                if not ptk:
                    break
                if ptk[0] in ("EYE", "LOOKAT", "UP"):
                    cam[ptk[0]] = ptk[1:]
                    i += 1
                else:
                    break
            continue
        i += 1

    res = (int(cam["RES"][0]), int(cam["RES"][1]))
    fovy = float(cam["FOVY"][0])
    position = np.array([float(x) for x in cam["EYE"]])
    lookat = np.array([float(x) for x in cam["LOOKAT"]])
    up = np.array([float(x) for x in cam.get("UP", ["0", "1", "0"])])

    # fov/pixelLength quirk: yscaled = tan(FULL fovy in rad)
    # (reference: src/scene.cpp:218-227)
    yscaled = _m.tan(fovy * PI / 180.0)
    xscaled = yscaled * res[0] / res[1]
    pixel_length = np.array([2 * xscaled / res[0], 2 * yscaled / res[1]])

    view = lookat - position
    view /= np.linalg.norm(view)
    # main.cpp camera basis rebuild: theta = degrees(SIN(view.y)) —
    # a quirk, not asin (reference: src/main.cpp:106-127, :172-190)
    phi = _m.degrees(_m.atan2(view[2], view[0]))
    theta = max(-89.0, min(89.0, _m.degrees(_m.sin(view[1]))))
    rt, rp = _m.radians(theta), _m.radians(phi)
    view = np.array([_m.cos(rt) * _m.cos(rp), _m.sin(rt),
                     _m.cos(rt) * _m.sin(rp)])
    u = np.array([0.0, 1.0, 0.0])  # main.cpp:184 hardcodes (0,1,0)
    r = np.cross(view, u)
    up = np.cross(r, view)
    up /= np.linalg.norm(up)
    right = r / np.linalg.norm(r)

    if tri_v:
        tri_v = np.concatenate(tri_v)
        tri_n = np.concatenate(tri_n)
        tri_uv = np.concatenate(tri_uv)
        tri_tan = np.concatenate(tri_tan)
        tri_geom = np.concatenate(tri_geom)
    else:
        tri_v = np.zeros((0, 3, 3))
        tri_n = np.zeros((0, 3, 3))
        tri_uv = np.zeros((0, 3, 2))
        tri_tan = np.zeros((0, 3))
        tri_geom = np.zeros(0, np.int64)

    # lights: analytic first, then emissive triangles
    # (reference: src/scene.cpp:538-558)
    lights = []
    for gi, g in enumerate(geoms):
        if mats[g.material].type == LIGHT and g.type != OBJ:
            lights.append((gi, -1, g.type))
    for ti in range(len(tri_v)):
        if mats[geoms[tri_geom[ti]].material].type == LIGHT:
            lights.append((int(tri_geom[ti]), ti, OBJ))

    sc = OScene(
        mats, geoms, tri_v, tri_n, tri_geom, tri_uv, tri_tan, env_map,
        lights, position, view, up, right, pixel_length, res,
        int(cam["DEPTH"][0]), int(cam["ITERATIONS"][0]), fovy,
    )
    _build_clusters(sc)
    return sc


def _build_clusters(sc: OScene, size: int = 128):
    """Morton-sorted fixed-size triangle clusters with AABBs — a pure
    speedup over the reference's flat loop (src/pathtrace.cu:281-296);
    the hit set is identical (min over all triangles)."""
    T = len(sc.tri_v)
    if T == 0:
        sc.cl_lo = np.zeros((0, 3))
        sc.cl_hi = np.zeros((0, 3))
        sc.cl_start = np.zeros(0, np.int64)
        sc.cl_end = np.zeros(0, np.int64)
        return
    cent = sc.tri_v.mean(axis=1)
    lo, hi = cent.min(0), cent.max(0)
    q = ((cent - lo) / np.maximum(hi - lo, 1e-12) * 1023).astype(np.uint64)

    def _spread(x):
        x &= np.uint64(0x3FF)
        x = (x | (x << np.uint64(16))) & np.uint64(0x030000FF)
        x = (x | (x << np.uint64(8))) & np.uint64(0x0300F00F)
        x = (x | (x << np.uint64(4))) & np.uint64(0x030C30C3)
        x = (x | (x << np.uint64(2))) & np.uint64(0x09249249)
        return x

    morton = (_spread(q[:, 0]) << np.uint64(2)) | (
        _spread(q[:, 1]) << np.uint64(1)) | _spread(q[:, 2])
    order = np.argsort(morton, kind="stable")
    sc.tri_v = sc.tri_v[order]
    sc.tri_n = sc.tri_n[order]
    sc.tri_uv = sc.tri_uv[order]
    sc.tri_tan = sc.tri_tan[order]
    sc.tri_geom = sc.tri_geom[order]
    # emissive-triangle light ids refer to triangle indices — remap
    inv = np.empty(T, np.int64)
    inv[order] = np.arange(T)
    sc.lights = [
        (g, int(inv[t]) if t >= 0 else -1, ty) for (g, t, ty) in sc.lights
    ]
    starts = np.arange(0, T, size)
    sc.cl_start = starts
    sc.cl_end = np.minimum(starts + size, T)
    sc.cl_lo = np.stack([
        sc.tri_v[s:e].reshape(-1, 3).min(0) for s, e in zip(sc.cl_start, sc.cl_end)
    ])
    sc.cl_hi = np.stack([
        sc.tri_v[s:e].reshape(-1, 3).max(0) for s, e in zip(sc.cl_start, sc.cl_end)
    ])


# --------------------------------------------------------------------------
# math/sampling (reference: src/utilities.h)
# --------------------------------------------------------------------------

def _dot(a, b):
    return (a * b).sum(-1)


def _norm(v):
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-38)


def process_nan(v):
    """reference: src/utilities.h:275-283 (per-component scrub)."""
    return np.where(np.isfinite(v), v, 0.0)


def pixar_onb(n):
    """Branchless Pixar frame (reference: src/utilities.h:188-207).
    n: (N,3) → (t, b) each (N,3).  NaN at n.z == -1 replicated."""
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    sz = np.where(z >= 0, 1.0, -1.0)
    a = 1.0 / (sz + z)
    sx = sz * x
    b = x * y * a
    t = np.stack([sx * x * a - 1.0, sz * b, sx], -1)
    bb = np.stack([b, y * y * a - sz, y], -1)
    return t, bb


def sample_hemisphere_cosine(n, r1, r2):
    """reference: src/utilities.h:225-236 (Pixar ONB + sqrt disk)."""
    t, b = pixar_onb(n)
    sin_t = np.sqrt(r1)
    cos_t = np.sqrt(1.0 - r1)
    phi = TWO_PI * r2
    return (
        (sin_t * np.cos(phi))[..., None] * t
        + (sin_t * np.sin(phi))[..., None] * b
        + cos_t[..., None] * n
    )


def sample_uniform_disc(r1, r2):
    """reference: src/utilities.h:295-300."""
    rad = np.sqrt(r1)
    th = TWO_PI * r2
    return rad * np.cos(th), rad * np.sin(th)


def sample_normal_ggx(n, wo, alpha, r1, r2):
    """Heitz VNDF (reference: src/utilities.h:351-377).  wo points away
    from the surface; alpha is whatever the caller passes (microfacet
    passes roughness, metallic passes roughness² — both quirks kept)."""
    t, b = pixar_onb(n)
    # world→local: rows are the frame vectors
    wol = np.stack([_dot(wo, t), _dot(wo, b), _dot(wo, n)], -1)
    whl = _norm(wol * np.stack(
        [alpha, alpha, np.ones_like(alpha)], -1))
    whl = np.where(whl[..., 2:3] < 0, -whl, whl)
    z = np.zeros_like(whl)
    z[..., 2] = 1.0
    t1 = np.where(
        (whl[..., 2:3] < 0.99999),
        _norm(np.cross(z, whl)),
        np.broadcast_to(np.array([1.0, 0.0, 0.0]), whl.shape),
    )
    t2 = np.cross(whl, t1)
    px, py = sample_uniform_disc(r1, r2)
    h = np.sqrt(1.0 - px * px)
    s = (1.0 + whl[..., 2]) / 2.0
    py = (1.0 - s) * h + s * py
    pz = np.sqrt(np.maximum(0.0, 1.0 - px * px - py * py))
    nh = px[..., None] * t1 + py[..., None] * t2 + pz[..., None] * whl
    nhs = np.stack([
        alpha * nh[..., 0], alpha * nh[..., 1],
        np.maximum(1e-6, nh[..., 2]),
    ], -1)
    # local→world
    return _norm(
        nhs[..., 0:1] * t + nhs[..., 1:2] * b + nhs[..., 2:3] * n
    )


def fresnel_schlick(f0, cos_t):
    """reference: src/utilities.h:326-329 (vec3 f0)."""
    p5 = (1.0 - cos_t) ** 5
    return f0 + (1.0 - f0) * p5[..., None]


def fresnel_maxwell(cos1, ior1, ior2):
    """Exact dielectric Fresnel (reference: src/utilities.h:332-342)."""
    sin1 = np.sqrt(np.maximum(1.0 - cos1 * cos1, 0.0))
    sin2 = sin1 * ior1 / ior2
    cos2 = np.sqrt(np.maximum(1.0 - sin2 * sin2, 0.0))
    r_pa = (ior1 * cos2 - ior2 * cos1) / (ior1 * cos2 + ior2 * cos1)
    r_pe = (ior1 * cos1 - ior2 * cos2) / (ior1 * cos1 + ior2 * cos2)
    f = (r_pa * r_pa + r_pe * r_pe) / 2.0
    return np.where(sin2 > 1.0, 1.0, f)


def smith_g1(a2, nov):
    """reference: src/utilities.h:419-424 (param NAMED a2; callers pass
    raw roughness — quirk kept at the call sites)."""
    return 2.0 * nov / (np.sqrt(nov * nov * (1.0 - a2) + a2) + nov)


def smith_g2(a2, nov, nol):
    """reference: src/utilities.h:411-416."""
    den = nol * np.sqrt(nov * nov * (1.0 - a2) + a2) + nov * np.sqrt(
        nol * nol * (1.0 - a2) + a2)
    return 2.0 * nov * nol / den


def ndf_ggx(cos_t, a2):
    """reference: src/utilities.h:427-436."""
    den = cos_t * cos_t * (a2 - 1.0) + 1.0
    d = a2 / (den * den * PI)
    return np.where(cos_t < 1e-6, 0.0, d)


def power_heuristic(f, g):
    """reference: src/utilities.h:432-436 — no clamping, so pdf=-1
    feeds straight in (g²=1)."""
    return (f * f) / (f * f + g * g)


def reflect(i, n):
    """glm::reflect."""
    return i - 2.0 * _dot(n, i)[..., None] * n


def get_reflect_dir(n, wo):
    """reference: src/utilities.h:289-293 (normal flipped against wo)."""
    nrm = np.where(_dot(wo, n)[..., None] < 0, n, -n)
    return wo - 2.0 * nrm * _dot(wo, nrm)[..., None]


def get_refract_dir(n, wo, ior1, ior2):
    """reference: src/utilities.h:310-320."""
    nrm = np.where(_dot(wo, n)[..., None] < 0, n, -n)
    eta = (ior1 / ior2)[..., None]
    r_perp = (wo - _dot(wo, nrm)[..., None] * nrm) * eta
    r_para = -np.sqrt(np.maximum(1.0 - _dot(r_perp, r_perp), 0.0))[
        ..., None] * nrm
    return r_perp + r_para


def aces_film(x):
    """reference: src/utilities.h:35-43."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return np.clip((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def gamma_correction(x):
    """reference: src/utilities.h:46-48."""
    return np.power(np.maximum(x, 0.0), 1.0 / 2.2)


# --------------------------------------------------------------------------
# intersections (reference: src/intersections.h, src/Bounds3.hpp:298-326)
# --------------------------------------------------------------------------

def _xform_point(m, p):
    return p @ m[:3, :3].T + m[:3, 3]


def _xform_vec(m, v):
    return v @ m[:3, :3].T


def box_intersect(g: OGeom, O, D):
    """Unit cube in object space (reference: src/intersections.h:48-91).
    Returns (t_world, point_world, normal_world): t = -1 on miss."""
    qo = _xform_point(g.inv, O)
    qd = _norm(_xform_vec(g.inv, D))
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (-0.5 - qo) / qd
        t2 = (0.5 - qo) / qd
    ta = np.minimum(t1, t2)
    tb = np.maximum(t1, t2)
    sign = np.where(t2 < t1, 1.0, -1.0)  # n[xyz] = t2<t1 ? +1 : -1
    # tmin = max over axes of ta WHERE ta > 0 (reference keeps -1e38
    # when no positive slab entry — port via masking)
    ta_m = np.where(ta > 0, ta, -1e38)
    tmin = ta_m.max(-1)
    amin = ta_m.argmax(-1)
    tmax = tb.min(-1)
    amax = tb.argmin(-1)
    hit = (tmax >= tmin) & (tmax > 0)
    inside = tmin <= 0
    t_obj = np.where(inside, tmax, tmin)
    axis = np.where(inside, amax, amin)
    n_obj = np.zeros_like(O)
    ar = np.arange(len(O))
    n_obj[ar, axis] = np.take_along_axis(sign, axis[:, None], 1)[:, 0]
    # getPointOnRay: (t - 1e-4) pull-back in OBJECT space
    # (reference: src/intersections.h:27,85)
    p_obj = qo + (t_obj - 1e-4)[..., None] * qd
    p_w = _xform_point(g.transform, p_obj)
    n_w = _norm(_xform_vec(g.invt, n_obj))
    t_w = np.linalg.norm(O - p_w, axis=-1)
    t_w = np.where(hit, t_w, -1.0)
    return t_w, p_w, n_w


def sphere_intersect(g: OGeom, O, D):
    """Unit sphere r=0.5 (reference: src/intersections.h:103-144)."""
    ro = _xform_point(g.inv, O)
    rd = _norm(_xform_vec(g.inv, D))
    vdd = _dot(ro, rd)
    radicand = vdd * vdd - (_dot(ro, ro) - 0.25)
    has = radicand >= 0
    sq = np.sqrt(np.maximum(radicand, 0.0))
    t1 = -vdd + sq
    t2 = -vdd - sq
    both_neg = (t1 < 0) & (t2 < 0)
    both_pos = (t1 > 0) & (t2 > 0)
    t_obj = np.where(both_pos, np.minimum(t1, t2), np.maximum(t1, t2))
    hit = has & ~both_neg
    p_obj = ro + (t_obj - 1e-4)[..., None] * rd
    p_w = _xform_point(g.transform, p_obj)
    n_w = _norm(_xform_vec(g.invt, p_obj))
    t_w = np.linalg.norm(O - p_w, axis=-1)
    t_w = np.where(hit, t_w, -1.0)
    return t_w, p_w, n_w


def tri_intersect(v0, v1, v2, O, D):
    """Möller–Trumbore (reference: src/Bounds3.hpp:298-326).
    Returns (hit, t, u, v) for O,D (N,3) vs one cluster (M,3) each —
    broadcasting to (N, M)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = np.cross(D[:, None, :], e2[None, :, :])
    det = (e1[None] * pvec).sum(-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv_det = 1.0 / det
    tvec = O[:, None, :] - v0[None]
    u = (tvec * pvec).sum(-1) * inv_det
    qvec = np.cross(tvec, e1[None])
    v = (D[:, None, :] * qvec).sum(-1) * inv_det
    t = (e2[None] * qvec).sum(-1) * inv_det
    hit = (det != 0) & (t >= 0) & (u >= 0) & (v >= 0) & (1 - u - v >= 0)
    return hit, t, u, v


def closest_hit(sc: OScene, O, D):
    """computeIntersections semantics (reference: src/pathtrace.cu:169-346):
    brute-force analytic geoms, then triangles; strict t_min > t updates.
    Returns dict of hit fields."""
    N = len(O)
    t_min = np.full(N, np.finfo(np.float64).max)
    hit_geom = np.full(N, -1, np.int64)
    tri_id = np.full(N, -1, np.int64)
    point = np.zeros((N, 3))
    normal = np.zeros((N, 3))
    uv = np.zeros((N, 2))
    tang = np.zeros((N, 3))
    for gi, g in enumerate(sc.geoms):
        if g.type == CUBE:
            t, p, n = box_intersect(g, O, D)
        elif g.type == SPHERE:
            t, p, n = sphere_intersect(g, O, D)
        else:
            continue
        upd = (t > 0) & (t_min > t)
        t_min = np.where(upd, t, t_min)
        hit_geom = np.where(upd, gi, hit_geom)
        point = np.where(upd[:, None], p, point)
        normal = np.where(upd[:, None], n, normal)
    # triangles — cluster-pruned brute force
    for ci in range(len(sc.cl_start)):
        near = _ray_aabb_any(sc.cl_lo[ci], sc.cl_hi[ci], O, D, t_min)
        if not near.any():
            continue
        idx = np.nonzero(near)[0]
        s, e = sc.cl_start[ci], sc.cl_end[ci]
        h, t, u, v = tri_intersect(
            sc.tri_v[s:e, 0], sc.tri_v[s:e, 1], sc.tri_v[s:e, 2],
            O[idx], D[idx],
        )
        t = np.where(h, t, np.finfo(np.float64).max)
        j = t.argmin(1)
        ar = np.arange(len(idx))
        tb, ub, vb = t[ar, j], u[ar, j], v[ar, j]
        hb = h[ar, j]
        upd = hb & (t_min[idx] > tb)
        gidx = idx[upd]
        jj = j[upd] + s
        t_min[gidx] = tb[upd]
        hit_geom[gidx] = sc.tri_geom[jj]
        tri_id[gidx] = jj
        w0 = (1 - ub - vb)[upd][:, None]
        w1 = ub[upd][:, None]
        w2 = vb[upd][:, None]
        # barycentric hit point/normal (reference: src/pathtrace.cu:269-272)
        point[gidx] = (
            w0 * sc.tri_v[jj, 0] + w1 * sc.tri_v[jj, 1] + w2 * sc.tri_v[jj, 2]
        )
        normal[gidx] = (
            w0 * sc.tri_n[jj, 0] + w1 * sc.tri_n[jj, 1] + w2 * sc.tri_n[jj, 2]
        )
        # barycentric texcoords + the PER-TRIANGLE tangent (reference:
        # src/pathtrace.cu:270-274 — T/B are not interpolated)
        uv[gidx] = (
            w0 * sc.tri_uv[jj, 0] + w1 * sc.tri_uv[jj, 1]
            + w2 * sc.tri_uv[jj, 2]
        )
        tang[gidx] = sc.tri_tan[jj]
    found = hit_geom >= 0
    normal = np.where(found[:, None], _norm(normal), normal)
    # texCoords clamped at intersection fill (reference: src/pathtrace.cu:318).
    # DELIBERATE DIVERGENCE (ADVICE r4): the reference taps normalSampler
    # with the UNCLAMPED texCoords (src/pathtrace.cu:323) and only stores
    # the clamped copy — but for UVs outside [0,1] that linearSample
    # (src/image.h:73-85) computes texel indices outside the image and
    # reads out of bounds (undefined behavior, not a semantic).  Both this
    # oracle and pathtracer (ops/traverse.py:422, clamp-to-edge taps)
    # clamp before every tap, so the two implementations agree with each
    # other and differ from the reference only where the reference is UB.
    uv = np.clip(uv, 0.0, 1.0)
    # normal mapping via the per-triangle TBN, gated on tangent validity
    # and a non-identity mapped normal (reference: src/pathtrace.cu:323-343;
    # quirk kept: localNorm = normalize(mapped - 0.5), NOT mapped*2-1)
    mat_of_geom = np.array([g.material for g in sc.geoms], np.int64)
    for mid, mat in enumerate(sc.materials):
        if mat.normal_map is None:
            continue
        sel = np.nonzero(found & (mat_of_geom[hit_geom] == mid))[0]
        if len(sel) == 0:
            continue
        mapped = bilinear_sample(mat.normal_map, uv[sel])
        local = _norm(mapped - 0.5)
        T = tang[sel]
        n = normal[sel]
        cond = (_dot(T, T) > 1e-3) & (np.abs(local[:, 2] - 1.0) > 1e-5)
        B = _norm(np.cross(n, T))
        T2 = _norm(np.cross(B, n))
        n2 = _norm(
            T2 * local[:, 0:1] + B * local[:, 1:2] + n * local[:, 2:3]
        )
        normal[sel] = np.where(cond[:, None], n2, n)
    return {
        "t": np.where(found, t_min, -1.0),
        "geom": hit_geom,
        "tri": tri_id,
        "point": point,
        "normal": normal,
        "uv": uv,
    }


def _ray_aabb_any(lo, hi, O, D, tmax):
    """Conservative slab test for cluster pruning (oracle accel only)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = (lo - O) / D
        t2 = (hi - O) / D
    ta = np.minimum(t1, t2).max(-1)
    tb = np.maximum(t1, t2).min(-1)
    return (tb >= ta) & (tb > 0) & (ta < tmax)


def occlusion_test(sc: OScene, ori, direction, des):
    """reference: src/lightSample.h:59-139.  Vectorized; returns bool
    occluded per lane.  Quirk windows kept exactly: geoms occlude when
    t > 0 and minT - 1e-5 > t and |t - minT| > 1e-2; triangles with
    1e-4 in place of 1e-2."""
    minT = np.linalg.norm(des - ori, axis=-1)
    occ = np.zeros(len(ori), bool)
    for g in sc.geoms:
        if g.type == CUBE:
            t, _, _ = box_intersect(g, ori, direction)
        elif g.type == SPHERE:
            t, _, _ = sphere_intersect(g, ori, direction)
        else:
            continue
        occ |= (t > 0) & (minT - 1e-5 > t) & (np.abs(t - minT) > 1e-2)
    for ci in range(len(sc.cl_start)):
        rem = ~occ
        near = rem & _ray_aabb_any(
            sc.cl_lo[ci], sc.cl_hi[ci], ori, direction,
            np.where(rem, minT, 0.0),
        )
        if not near.any():
            continue
        idx = np.nonzero(near)[0]
        s, e = sc.cl_start[ci], sc.cl_end[ci]
        h, t, _, _ = tri_intersect(
            sc.tri_v[s:e, 0], sc.tri_v[s:e, 1], sc.tri_v[s:e, 2],
            ori[idx], direction[idx],
        )
        m = minT[idx][:, None]
        bad = h & (m - 1e-5 > t) & (np.abs(t - m) > 1e-4)
        occ[idx] |= bad.any(1)
    return occ


# --------------------------------------------------------------------------
# materials (reference: src/material.h)
# --------------------------------------------------------------------------

def _mat_arrays(sc: OScene):
    a = np.stack([m.albedo for m in sc.materials])
    return {
        "type": np.array([m.type for m in sc.materials]),
        "albedo": a,
        "metallic": np.array([m.metallic for m in sc.materials]),
        "roughness": np.array([
            min(max(m.roughness, ROUGHNESS_MIN), ROUGHNESS_MAX)
            for m in sc.materials
        ]),  # sample-time clamp (reference: src/material.h:274,324)
        "ior": np.array([m.ior for m in sc.materials]),
    }


def microfacet_bsdf(n, wo, wi, albedo, rough):
    """reference: src/material.h:246-260.  wo points AWAY (-ray dir)."""
    a2 = rough * rough
    cos_o = _dot(n, wo)
    cos_i = _dot(n, wi)
    wm = _norm(wo + wi)
    d = ndf_ggx(_dot(wm, n), a2)
    g2 = smith_g2(rough, cos_o, cos_i)  # quirk: raw roughness as a2
    f = fresnel_schlick(albedo, _dot(wo, wm))
    val = f * (d * g2 / np.maximum(4 * cos_o * cos_i, 1e-8))[..., None]
    return np.where((cos_o * cos_i < 1e-7)[..., None], 0.0, val)


def microfacet_pdf(n, wo, wi, rough):
    """reference: src/material.h:262-270."""
    a2 = rough * rough
    cos_o = _dot(n, wo)
    wm = _norm(wo + wi)
    d = ndf_ggx(_dot(wm, n), a2)
    g1 = smith_g1(rough, cos_o)  # quirk: raw roughness as a2
    return g1 * d / np.maximum(4 * _dot(wo, n), 1e-8)


def metallic_bsdf(n, wo, wi, albedo, rough, metal):
    """reference: src/material.h:297-311."""
    a2 = rough * rough
    cos_o = _dot(n, wo)
    cos_i = _dot(n, wi)
    wm = _norm(wo + wi)
    d = ndf_ggx(_dot(wm, n), a2)
    g2 = smith_g2(rough, cos_o, cos_i)  # quirk: raw roughness
    f0 = 0.08 * (1 - metal[..., None]) + albedo * metal[..., None]
    f = fresnel_schlick(f0, _dot(wo, wm))
    diffuse = (1.0 - metal)[..., None] * albedo * INV_PI
    spec = (d * g2 / np.maximum(4 * cos_o * cos_i, 1e-8))[..., None]
    val = diffuse * (1 - f) + spec * f
    return np.where((cos_o * cos_i < 1e-7)[..., None], 0.0, val)


def metallic_pdf(n, wo, wi, rough, metal):
    """reference: src/material.h:313-321."""
    a2 = rough * rough
    cos_o = _dot(n, wo)
    wm = _norm(wo + wi)
    d = ndf_ggx(_dot(wm, n), a2)
    g1 = smith_g1(rough, cos_o)
    spec = g1 * d / np.maximum(4 * _dot(wo, n), 1e-8)
    diff = _dot(wi, n) * INV_PI
    w = 1.0 / (2.0 - metal)
    return diff * (1 - w) + spec * w


def _sampled_params(m: OMaterial, uvm: np.ndarray):
    """Per-lane (albedo, roughness, metallic) with the sample-time clamps
    (reference: src/material.h:274-275,325-327,486-489): each value comes
    from the material's texture when mapped, else the constant."""
    k = len(uvm)
    if m.albedo_map is not None:
        alb = bilinear_sample(m.albedo_map, uvm)
    else:
        alb = np.broadcast_to(m.albedo, (k, 3))
    if m.roughness_map is not None:
        rough = bilinear_sample(m.roughness_map, uvm)[:, 0]
    else:
        rough = np.full(k, m.roughness)
    rough = np.clip(rough, ROUGHNESS_MIN, ROUGHNESS_MAX)
    if m.metallic_map is not None:
        metal = bilinear_sample(m.metallic_map, uvm)[:, 0]
    else:
        metal = np.full(k, m.metallic)
    metal = np.clip(metal, 0.0, 1.0)
    return alb, rough, metal


def scatter_sample(sc, mats, mat_id, n, d, uv, rng):
    """Material::scatterSample (reference: src/material.h:450-481).
    d = incoming ray direction (the kernels pass ray.direction as 'wo').
    Returns (bsdf (N,3), pdf (N,), dir (N,3), delta (N,))."""
    N = len(n)
    bsdf = np.zeros((N, 3))
    pdf = np.zeros(N)
    out = np.zeros((N, 3))
    delta = np.zeros(N, bool)
    mtype = mats["type"][mat_id]
    for mid in np.unique(mat_id):
        sel = np.nonzero(mat_id == mid)[0]
        m = sc.materials[mid]
        nn = n[sel]
        dd = d[sel]
        alb, rough, metal = _sampled_params(m, uv[sel])
        if m.type == LAMBERTIAN:
            # reference: src/material.h:55-61
            r = rng.random((len(sel), 2))
            wi = sample_hemisphere_cosine(nn, r[:, 0], r[:, 1])
            bsdf[sel] = alb * INV_PI
            pdf[sel] = _dot(wi, nn) * INV_PI
            out[sel] = wi
        elif m.type == DIELECTRIC:
            # reference: src/material.h:81-114
            entering = _dot(dd, nn) < 0
            ior1 = np.where(entering, 1.0, m.ior)
            ior2 = np.where(entering, m.ior, 1.0)
            fr = fresnel_maxwell(np.abs(_dot(dd, nn)), ior1, ior2)
            r = rng.random(len(sel))
            refl = r < fr
            wi = np.where(
                refl[:, None],
                get_reflect_dir(nn, dd),
                get_refract_dir(nn, dd, ior1, ior2),
            )
            b = np.where(
                refl[:, None],
                alb,
                alb * ((ior2 * ior2) / (ior1 * ior1))[:, None],
            )
            bsdf[sel] = b / np.abs(_dot(wi, nn))[:, None]
            pdf[sel] = 1.0
            out[sel] = wi
            delta[sel] = True
        elif m.type == MICROFACET:
            # reference: src/material.h:272-295 — VNDF gets RAW roughness
            r = rng.random((len(sel), 2))
            wm = sample_normal_ggx(nn, -dd, rough, r[:, 0], r[:, 1])
            wi = reflect(dd, wm)
            bad = _dot(wi, nn) * _dot(-dd, nn) < 0
            b = microfacet_bsdf(nn, -dd, wi, alb, rough)
            p = microfacet_pdf(nn, -dd, wi, rough)
            bsdf[sel] = np.where(bad[:, None], 0.0, b)
            pdf[sel] = np.where(bad, 0.0, p)
            out[sel] = wi
        elif m.type == METALLIC_WORKFLOW:
            # reference: src/material.h:323-357 — VNDF gets roughness²
            r1 = rng.random(len(sel))
            r = rng.random((len(sel), 2))
            spec_pick = r1 < 1.0 / (2.0 - metal)
            wm = sample_normal_ggx(nn, -dd, rough * rough, r[:, 0], r[:, 1])
            wi_spec = reflect(dd, wm)
            wi_diff = sample_hemisphere_cosine(nn, r[:, 0], r[:, 1])
            wi = np.where(spec_pick[:, None], wi_spec, wi_diff)
            bad = (_dot(-dd, nn) < 0) | (_dot(wi, nn) < 0)
            b = metallic_bsdf(nn, -dd, wi, alb, rough, metal)
            p = metallic_pdf(nn, -dd, wi, rough, metal)
            bsdf[sel] = np.where(bad[:, None], 0.0, b)
            pdf[sel] = np.where(bad, 0.0, p)
            out[sel] = wi
        elif m.type == LIGHT:
            # reference: src/material.h:470-473 (raw constant, no sampler)
            bsdf[sel] = m.albedo
            pdf[sel] = 1.0
    return bsdf, pdf, out, delta, mtype


def bsdf_eval(sc, mat_id, n, d, uv, wi):
    """Material::BSDF (reference: src/material.h:483-501); d = ray dir."""
    out = np.zeros((len(n), 3))
    for mid in np.unique(mat_id):
        sel = np.nonzero(mat_id == mid)[0]
        m = sc.materials[mid]
        alb, rough, metal = _sampled_params(m, uv[sel])
        if m.type == LAMBERTIAN:
            out[sel] = alb * INV_PI
        elif m.type == MICROFACET:
            out[sel] = microfacet_bsdf(n[sel], -d[sel], wi[sel], alb, rough)
        elif m.type == METALLIC_WORKFLOW:
            out[sel] = metallic_bsdf(
                n[sel], -d[sel], wi[sel], alb, rough, metal)
        # dielectric/light → 0
    return out


def pdf_eval(sc, mat_id, n, d, uv, wi):
    """Material::pdf (reference: src/material.h:503-521)."""
    out = np.zeros(len(n))
    for mid in np.unique(mat_id):
        sel = np.nonzero(mat_id == mid)[0]
        m = sc.materials[mid]
        _, rough, metal = _sampled_params(m, uv[sel])
        if m.type == LAMBERTIAN:
            out[sel] = _dot(wi[sel], n[sel]) * INV_PI
        elif m.type == MICROFACET:
            out[sel] = microfacet_pdf(n[sel], -d[sel], wi[sel], rough)
        elif m.type == METALLIC_WORKFLOW:
            out[sel] = metallic_pdf(n[sel], -d[sel], wi[sel], rough, metal)
    return out


# --------------------------------------------------------------------------
# light sampler (reference: src/lightSample.h:141-248)
# --------------------------------------------------------------------------

def light_sample(sc: OScene, view_pos, rng):
    """LightSampler::lightSample (reference: src/lightSample.h:171-248).
    Returns (pos, emit, pdf).  Cube lights: no branch → pdf=0, pos=0
    (the reference leaves lightPos uninitialized; every consumer zeroes
    the contribution through pdf=0/weight=0, so 0 is equivalent)."""
    N = len(view_pos)
    L = len(sc.lights)
    pos = np.zeros((N, 3))
    emit = np.zeros((N, 3))
    pdf = np.zeros(N)
    if L == 0:
        return pos, emit, pdf
    pick = np.minimum(rng.random(N) * L, L - 1.0).astype(np.int64)
    r2 = rng.random((N, 2))
    for li in range(L):
        sel = np.nonzero(pick == li)[0]
        if len(sel) == 0:
            continue
        gid, tid, gtype = sc.lights[li]
        g = sc.geoms[gid]
        albedo = sc.materials[g.material].albedo
        if tid >= 0:
            # triangle light: uniform area (reference: lightSample.h:186-200)
            # NOTE barycentric convention: pos = u·v0 + v·v1 + (1-u-v)·v2
            t = np.sqrt(r2[sel, 0])
            u = 1.0 - t
            v = t * (1.0 - r2[sel, 1])
            tv = sc.tri_v[tid]
            tn = sc.tri_n[tid]
            lp = u[:, None] * tv[0] + v[:, None] * tv[1] + (
                1 - u - v)[:, None] * tv[2]
            nrm = _norm(u[:, None] * tn[0] + v[:, None] * tn[1] + (
                1 - u - v)[:, None] * tn[2])
            area = np.linalg.norm(
                np.cross(tv[1] - tv[0], tv[2] - tv[0])) / 2.0
            d2 = ((lp - view_pos[sel]) ** 2).sum(-1)
            cosl = np.abs(_dot(_norm(view_pos[sel] - lp), nrm))
            p = (1.0 / L) * d2 / (area * cosl)
        elif gtype == SPHERE:
            # cone sampling in object space, radius hardcoded 0.5
            # (reference: lightSample.h:202-234)
            vl = _xform_point(g.inv, view_pos[sel])
            ctr = -vl  # center - viewPosL with center = 0
            c2r = _norm(ctr)
            tan, bit = pixar_onb(c2r)
            d2 = (vl * vl).sum(-1)
            sin_max2 = 0.25 / d2
            cos_max = np.sqrt(np.maximum(0.0, 1.0 - sin_max2))
            xi = r2[sel]
            cos_t = (1.0 - xi[:, 0]) + xi[:, 0] * cos_max
            sin_t = np.sqrt(np.maximum(0.0, 1.0 - cos_t * cos_t))
            phi = xi[:, 1] * TWO_PI
            dc = np.sqrt(d2)
            ds = dc * cos_t - np.sqrt(
                np.maximum(0.0, 0.25 - dc * dc * sin_t * sin_t))
            sin_a = ds * sin_t / 0.5
            cos_a = np.sqrt(np.maximum(0.0, 1.0 - sin_a * sin_a))
            n_obj = (sin_a * np.cos(phi))[:, None] * tan + (
                sin_a * np.sin(phi))[:, None] * bit + cos_a[:, None] * (-c2r)
            p_obj = n_obj * 0.5
            lp = _xform_point(g.transform, p_obj)
            p = 1.0 / (TWO_PI * (1.0 - cos_max) * L)
            nrm = None
        else:
            # CUBE: no branch in the reference — pdf stays 0
            lp = np.zeros((len(sel), 3))
            p = np.zeros(len(sel))
        pos[sel] = lp
        pdf[sel] = p
        emit[sel] = albedo
    # shadow ray (reference: lightSample.h:237-243)
    ray_dir = _norm(pos - view_pos)
    occ = occlusion_test(sc, view_pos + 1e-5 * ray_dir, ray_dir, pos)
    emit = np.where(occ[:, None], 0.0, emit)
    pdf = np.where(occ, -1.0, pdf)
    return pos, emit, pdf


def light_pdf(sc: OScene, view_pos, light_pos, normal, tri_id, geom_id):
    """LightSampler::lightPDF (reference: src/lightSample.h:141-169).
    Note the sphere branch OVERRIDES the triangle branch (if, not elif)."""
    L = len(sc.lights)
    pdf = np.full(len(view_pos), -1.0)
    tri_sel = tri_id >= 0
    if tri_sel.any():
        idx = np.nonzero(tri_sel)[0]
        tv = sc.tri_v[tri_id[idx]]
        area = np.linalg.norm(
            np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0]), axis=-1) / 2.0
        d2 = ((light_pos[idx] - view_pos[idx]) ** 2).sum(-1)
        cosl = np.abs(_dot(_norm(view_pos[idx] - light_pos[idx]), normal[idx]))
        pdf[idx] = (1.0 / L) * d2 / (area * cosl)
    for gi, g in enumerate(sc.geoms):
        if g.type != SPHERE:
            continue
        sel = np.nonzero(geom_id == gi)[0]
        if len(sel) == 0:
            continue
        vl = _xform_point(g.inv, view_pos[sel])
        sin_max2 = 0.25 / (vl * vl).sum(-1)
        cos_max = np.sqrt(np.maximum(0.0, 1.0 - sin_max2))
        pdf[sel] = 1.0 / (TWO_PI * (1.0 - cos_max) * L)
    return pdf


# --------------------------------------------------------------------------
# integrator (reference: src/pathtrace.cu:348-588, 637-797)
# --------------------------------------------------------------------------

def render(sc: OScene, mode: str = "bsdf", spp: int = 16,
           width: int = None, height: int = None, depth: int = None,
           seed: int = 0, progress=None):
    """Progressive render; returns linear (H, W, 3) mean radiance.
    mode: 'bsdf' (PTkernel), 'direct' (DirectLiPTkernel), 'mis'
    (MisPTkernel)."""
    W = width or sc.resolution[0]
    H = height or sc.resolution[1]
    trace_depth = depth or sc.trace_depth
    # pixelLength depends on the render resolution (reference:
    # src/scene.cpp:219-227) — recompute it when W/H override the scene's
    pl = sc.pixel_length
    if (W, H) != tuple(sc.resolution):
        yscaled = _m.tan(sc.fovy * PI / 180.0)
        xscaled = yscaled * W / H
        pl = np.array([2 * xscaled / W, 2 * yscaled / H])
    img = np.zeros((W * H, 3))
    xs = np.arange(W * H) % W
    ys = np.arange(W * H) // W
    for it in range(1, spp + 1):
        rng = np.random.Generator(np.random.PCG64(seed * 1_000_003 + it))
        # generateRayFromCamera (reference: src/pathtrace.cu:135-163)
        r = rng.random((W * H, 2))
        D = _norm(
            sc.cam_view
            - sc.cam_right[None] * (
                pl[0] * (xs + r[:, 0] - 0.5 - W * 0.5)
            )[:, None]
            - sc.cam_up[None] * (
                pl[1] * (ys + r[:, 1] - 0.5 - H * 0.5)
            )[:, None]
        )
        O = np.broadcast_to(sc.cam_position, (W * H, 3)).copy()
        color = np.ones((W * H, 3))
        prev_pdf = np.full(W * H, -1.0)
        pix = np.arange(W * H)
        bounces = np.full(W * H, trace_depth)
        alive = np.arange(W * H)
        d = 0
        while len(alive) and d <= trace_depth + 1:
            d += 1
            hit = closest_hit(sc, O[alive], D[alive])
            found = hit["t"] > 0
            # miss → dead, env radiance accumulated in every mode
            # (reference: src/pathtrace.cu:303-311)
            if sc.env_map is not None and (~found).any():
                miss = alive[~found]
                env = bilinear_sample(sc.env_map, sphere2plane(D[miss]))
                np.add.at(img, pix[miss], process_nan(color[miss] * env))
            lanes = alive[found]
            if len(lanes) == 0:
                break
            n = hit["normal"][found]
            p = hit["point"][found]
            gid = hit["geom"][found]
            tid = hit["tri"][found]
            uvh = hit["uv"][found]
            mat_id = np.array(
                [sc.geoms[g].material for g in gid], np.int64)
            dirs = D[lanes]
            cols = color[lanes]
            bsdf, pdf, wi, delta, _ = scatter_sample(
                sc, _mat_arrays(sc), mat_id, n, dirs, uvh, rng)
            is_light = np.array(
                [sc.materials[m].type == LIGHT for m in mat_id])
            live = np.ones(len(lanes), bool)

            if mode == "direct":
                # reference: src/pathtrace.cu:348-403
                lp, emit, lpdf = light_sample(sc, p, rng)
                liwi = _norm(lp - p)
                li_bsdf = bsdf_eval(sc, mat_id, n, dirs, uvh, liwi)
                contrib = (
                    li_bsdf * emit
                    * np.maximum(_dot(liwi, n), 0.0)[:, None]
                    / lpdf[:, None]
                ) * cols
                contrib = np.where(lpdf[:, None] <= 0, 0.0, contrib)
                lhit = cols * np.stack(
                    [sc.materials[m].albedo for m in mat_id])
                total = np.where(is_light[:, None], lhit, contrib)
                np.add.at(img, pix[lanes], process_nan(total))
                live[:] = False
            else:
                dead_pdf = pdf == 0
                if mode == "mis":
                    # light hit: MIS weight vs prevPdf
                    # (reference: src/pathtrace.cu:545-558)
                    wsel = is_light & ~dead_pdf
                    if wsel.any():
                        w = np.ones(wsel.sum())
                        pv = prev_pdf[lanes[wsel]]
                        need = pv > 0
                        if need.any():
                            lq = light_pdf(
                                sc, O[lanes[wsel]][need], p[wsel][need],
                                n[wsel][need], tid[wsel][need],
                                gid[wsel][need])
                            w[need] = power_heuristic(pv[need], lq)
                        lc = cols[wsel] * (
                            bsdf[wsel] / pdf[wsel][:, None]) * w[:, None]
                        np.add.at(img, pix[lanes[wsel]], process_nan(lc))
                    # NEE on non-delta (reference: src/pathtrace.cu:560-571)
                    nsel = ~is_light & ~dead_pdf & ~delta
                    if nsel.any():
                        lp, emit, lpdf = light_sample(sc, p[nsel], rng)
                        liwi = _norm(lp - p[nsel])
                        bp = pdf_eval(
                            sc, mat_id[nsel], n[nsel], dirs[nsel],
                            uvh[nsel], liwi)
                        lb = bsdf_eval(
                            sc, mat_id[nsel], n[nsel], dirs[nsel],
                            uvh[nsel], liwi)
                        w = power_heuristic(lpdf, bp)
                        nee = (
                            w[:, None] * cols[nsel] * emit * lb
                            * np.maximum(_dot(liwi, n[nsel]), 0.0)[:, None]
                            / lpdf[:, None]
                        )
                        np.add.at(img, pix[lanes[nsel]], process_nan(nee))
                else:
                    # BSDF mode light hit (reference: src/pathtrace.cu:470-475)
                    wsel = is_light & ~dead_pdf
                    if wsel.any():
                        lc = cols[wsel] * (bsdf[wsel] / pdf[wsel][:, None])
                        np.add.at(img, pix[lanes[wsel]], process_nan(lc))

                # continuation (reference: src/pathtrace.cu:476-497,573-587)
                cont = ~is_light & ~dead_pdf
                mtypes = np.array(
                    [sc.materials[m].type for m in mat_id])
                off_dir = np.where(
                    _dot(wi, n)[:, None] > 0, n, -n)
                new_o = np.where(
                    (mtypes == DIELECTRIC)[:, None],
                    p + 1e-3 * off_dir,
                    p + 1e-4 * wi,
                )
                new_c = cols * bsdf * np.abs(_dot(wi, n))[:, None] / np.where(
                    pdf == 0, 1.0, pdf)[:, None]
                lsel = lanes[cont]
                O[lsel] = new_o[cont]
                D[lsel] = wi[cont]
                color[lsel] = new_c[cont]
                if mode == "mis":
                    prev_pdf[lsel] = np.where(
                        delta[cont], -1.0, pdf[cont])
                bounces[lsel] -= 1
                live = cont & (bounces[lanes] > 0)
            alive = lanes[live]
        if progress:
            progress(it, spp)
    return (img / spp).reshape(H, W, 3)


def ldr(linear_img):
    """display transform (reference: src/pathtrace.cu:45-50; NO X-mirror)."""
    return gamma_correction(aces_film(linear_img))

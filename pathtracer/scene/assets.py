"""Seeded generator for the mesh, texture and environment assets the
in-repo scenes reference.

The scenes under `scenes/` point at `generated/<file>` relative to the
scene file.  Those files are not committed: this module writes them,
deterministically from one seed, into `scenes/generated/` (listed in
`.gitignore`).  Run it once before rendering a scene that needs them:

    python -m pathtracer.scene.assets [--seed N] [--out DIR]

`chip_smoke.py`, `bench.py` and the test session call `ensure_assets()`
first, which regenerates only when the manifest does not match.

Assets:
- `blob.obj`: a closed, noise-displaced geodesic sphere (~15.7k
  triangles, shared vertices, area-weighted vertex normals).  It stands in
  for the reference's 10k-triangle bunny: a closed curved mesh whose
  triangles are neither coplanar nor regular, so its BVH looks like a
  scanned model's and not like a subdivided solid's.
- `cubetex.obj`: a unit cube with per-face [0,1]^2 UVs (12 triangles).
- `texture.png`: an 8-bit RGB checker with colour gradients.
- `sky.hdr`: an RGBE sky with a bright sun, for the environment scenes.
"""

from __future__ import annotations

import argparse
import json
import os
from pathlib import Path

import numpy as np

from pathtracer.utils.image_io import write_hdr, write_png

DEFAULT_SEED = 20240611
ASSET_DIR = Path(__file__).resolve().parents[2] / "scenes" / "generated"
_VERSION = 1  # bump when any generator's output changes
BLOB_FREQUENCY = 28  # geodesic frequency: 20·f² triangles (28 → 15,680)


def _atomic_write(path: Path, write) -> None:
    """Write via a temp file + rename, so concurrent generators (test
    workers) never expose a half-written file."""
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    write(tmp)
    os.replace(tmp, path)


def _icosahedron():
    t = (1.0 + 5.0 ** 0.5) / 2.0
    v = np.array(
        [[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
         [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
         [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    f = np.array(
        [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
         [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
         [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
         [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)
    return v / np.linalg.norm(v, axis=1, keepdims=True), f


def geodesic_sphere(freq: int) -> tuple[np.ndarray, np.ndarray]:
    """Unit sphere from an icosahedron whose faces are split into freq²
    triangles on a barycentric grid and projected outward.  Returns
    (vertices (V,3), faces (20·freq², 3)) with shared vertices, faces
    wound outward."""
    base_v, base_f = _icosahedron()
    # grid points (i, j) with i + j <= freq, and their local ids
    ij = [(i, j) for i in range(freq + 1) for j in range(freq + 1 - i)]
    lid = {p: k for k, p in enumerate(ij)}
    w = np.array([(freq - i - j, i, j) for i, j in ij], np.float64) / freq
    tris = []
    for i in range(freq):
        for j in range(freq - i):
            tris.append((lid[i, j], lid[i + 1, j], lid[i, j + 1]))
            if i + j < freq - 1:
                tris.append((lid[i + 1, j], lid[i + 1, j + 1], lid[i, j + 1]))
    tris = np.asarray(tris, np.int64)
    pts = np.einsum("pk,fkc->fpc", w, base_v[base_f])  # (20, P, 3)
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    flat = pts.reshape(-1, 3)
    # weld the copies of shared edge/corner points (rounded positions)
    _, first, inv = np.unique(
        np.round(flat, 9), axis=0, return_index=True, return_inverse=True
    )
    verts = flat[first]
    inv = inv.reshape(-1)
    faces = (tris[None] + (np.arange(20) * len(ij))[:, None, None]).reshape(-1, 3)
    return verts, inv[faces]


def blob_mesh(seed: int = DEFAULT_SEED, freq: int = BLOB_FREQUENCY):
    """Noise-displaced geodesic sphere: radius 0.33 modulated by a sum of
    random plane waves (±~20%), so neighbouring triangles are never
    coplanar.  Returns (vertices, faces, vertex normals)."""
    rng = np.random.default_rng(seed)
    verts, faces = geodesic_sphere(freq)
    k = 16
    dirs = rng.normal(size=(k, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    freqs = rng.uniform(1.5, 7.0, size=k)
    amps = rng.uniform(0.5, 1.0, size=k) / freqs
    phases = rng.uniform(0.0, 2.0 * np.pi, size=k)
    disp = (np.sin(verts @ (dirs * freqs[:, None]).T + phases) * amps).sum(axis=1)
    disp *= 0.2 / np.abs(disp).max()
    verts = verts * (0.33 * (1.0 + disp))[:, None]
    # area-weighted vertex normals (cross product length = 2·area)
    tri = verts[faces]
    fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    vn = np.zeros_like(verts)
    for c in range(3):
        np.add.at(vn, faces[:, c], fn)
    vn /= np.linalg.norm(vn, axis=1, keepdims=True)
    return verts, faces, vn


def _write_obj(path: Path, verts, faces, normals=None, uvs=None, face_uv=None):
    lines = [f"v {x:.7f} {y:.7f} {z:.7f}" for x, y, z in verts]
    if uvs is not None:
        lines += [f"vt {u:.7f} {v:.7f}" for u, v in uvs]
    if normals is not None:
        lines += [f"vn {x:.7f} {y:.7f} {z:.7f}" for x, y, z in normals]
    for fi, (a, b, c) in enumerate(faces + 1):
        if uvs is not None:
            ta, tb, tc = face_uv[fi] + 1
            lines.append(f"f {a}/{ta}/{a} {b}/{tb}/{b} {c}/{tc}/{c}")
        else:
            lines.append(f"f {a}//{a} {b}//{b} {c}//{c}")
    _atomic_write(path, lambda p: p.write_text("\n".join(lines) + "\n"))


def _write_cube(path: Path):
    """Unit cube (±0.5) with per-face UVs and face normals: 24 vertices so
    each face owns its corners (the TBN bake needs per-face UVs)."""
    verts, normals, uvs, faces, face_uv = [], [], [], [], []
    for axis in range(3):
        for sign in (1.0, -1.0):
            n = np.zeros(3)
            n[axis] = sign
            u_ax, v_ax = [a for a in range(3) if a != axis]
            base = len(verts)
            for du, dv in ((0, 0), (1, 0), (1, 1), (0, 1)):
                p = np.zeros(3)
                p[axis] = 0.5 * sign
                p[u_ax] = du - 0.5
                p[v_ax] = dv - 0.5
                verts.append(p)
                normals.append(n)
                uvs.append((du, dv))
            quad = [(0, 1, 2), (0, 2, 3)]
            # wind counter-clockwise seen from outside
            flip = np.dot(np.cross(np.eye(3)[u_ax], np.eye(3)[v_ax]), n) < 0
            for a, b, c in quad:
                tri = (base + a, base + c, base + b) if flip else (base + a, base + b, base + c)
                faces.append(tri)
                face_uv.append(tri)
    _write_obj(path, np.asarray(verts), np.asarray(faces), np.asarray(normals),
               np.asarray(uvs, np.float64), np.asarray(face_uv))


def texture_image(seed: int = DEFAULT_SEED, size: int = 512) -> np.ndarray:
    """8-bit RGB checker (8x8 cells) over hue gradients, plus seeded noise."""
    rng = np.random.default_rng(seed + 1)
    y, x = np.mgrid[0:size, 0:size] / size
    check = ((np.floor(x * 8) + np.floor(y * 8)) % 2)[..., None]
    grad = np.stack([x, y, 1.0 - 0.5 * (x + y)], axis=-1)
    img = 0.25 + 0.6 * grad * (0.45 + 0.55 * check)
    img += rng.normal(scale=0.02, size=img.shape)
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def sky_image(seed: int = DEFAULT_SEED, width: int = 512, height: int = 256) -> np.ndarray:
    """Lat-long HDR sky: horizon-to-zenith gradient, a darker ground and
    one bright sun disk (peak ~60, so env importance sampling matters)."""
    rng = np.random.default_rng(seed + 2)
    v, u = (np.mgrid[0:height, 0:width] + 0.5) / np.array([height, width])[:, None, None]
    elev = 0.5 - v  # +0.5 zenith, -0.5 nadir
    sky = np.stack([0.35 + 0.4 * elev, 0.5 + 0.4 * elev, 0.9 + 0.3 * elev], -1)
    ground = np.stack([0.25, 0.2, 0.15], -1) * np.ones_like(sky)
    img = np.where((elev > 0)[..., None], sky, ground)
    su, sv = rng.uniform(0.1, 0.9), rng.uniform(0.2, 0.35)
    d2 = ((u - su) * 2.0) ** 2 + (v - sv) ** 2
    img = img + (60.0 * np.exp(-d2 / 2e-4))[..., None] * np.array([1.0, 0.9, 0.7])
    return img.astype(np.float32)


FILES = ("blob.obj", "cubetex.obj", "texture.png", "sky.hdr")


def generate(out_dir: Path = ASSET_DIR, seed: int = DEFAULT_SEED) -> Path:
    """Write every asset into `out_dir` (created) and return it."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    verts, faces, normals = blob_mesh(seed)
    _write_obj(out_dir / "blob.obj", verts, faces, normals)
    _write_cube(out_dir / "cubetex.obj")
    _atomic_write(out_dir / "texture.png",
                  lambda p: write_png(p, texture_image(seed)))
    _atomic_write(out_dir / "sky.hdr", lambda p: write_hdr(p, sky_image(seed)))
    manifest = json.dumps({"version": _VERSION, "seed": seed, "files": FILES})
    _atomic_write(out_dir / "manifest.json", lambda p: p.write_text(manifest))
    return out_dir


def ensure_assets(out_dir: Path = ASSET_DIR, seed: int = DEFAULT_SEED) -> Path:
    """Generate the assets unless `out_dir` already holds this version's."""
    out_dir = Path(out_dir)
    want = {"version": _VERSION, "seed": seed, "files": list(FILES)}
    try:
        have = json.loads((out_dir / "manifest.json").read_text())
    except (OSError, ValueError):
        have = None
    if have != want or not all((out_dir / f).is_file() for f in FILES):
        generate(out_dir, seed)
    return out_dir


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=DEFAULT_SEED)
    ap.add_argument("--out", type=Path, default=ASSET_DIR)
    args = ap.parse_args(argv)
    out = generate(args.out, args.seed)
    print(f"wrote {', '.join(FILES)} to {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Image I/O without Pillow, the compile-cache location, and the seeded
asset generator."""

import json
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest

from pathtracer.scene import assets
from pathtracer.utils import jaxcache
from pathtracer.utils.image_io import (
    decode_png,
    load_image,
    read_hdr,
    read_png,
    write_hdr,
    write_png,
)

REPO = Path(__file__).resolve().parent.parent


def _encode_png(img: np.ndarray, ctype: int, ftype: int) -> bytes:
    """Minimal PNG encoder that applies ONE filter type to every row (RFC
    2083 section 6), so each decoder branch is exercised on its own."""
    h, w, c = img.shape
    rows = img.reshape(h, w * c).astype(np.int64)
    out = []
    prior = np.zeros(w * c, np.int64)
    for y in range(h):
        x = rows[y]
        a = np.concatenate([np.zeros(c, np.int64), x[:-c]])
        pc = np.concatenate([np.zeros(c, np.int64), prior[:-c]])
        if ftype == 0:
            f = x
        elif ftype == 1:
            f = x - a
        elif ftype == 2:
            f = x - prior
        elif ftype == 3:
            f = x - (a + prior) // 2
        else:
            p = a + prior - pc
            pa, pb, pcc = np.abs(p - a), np.abs(p - prior), np.abs(p - pc)
            pred = np.where((pa <= pb) & (pa <= pcc), a, np.where(pb <= pcc, prior, pc))
            f = x - pred
        out.append(bytes([ftype]) + (f % 256).astype(np.uint8).tobytes())
        prior = x

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out)))
            + chunk(b"IEND", b""))


class TestPng:
    @pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
    @pytest.mark.parametrize("ctype,channels", [(0, 1), (2, 3), (6, 4)])
    def test_decode_each_filter(self, ftype, ctype, channels):
        rng = np.random.default_rng(ftype * 10 + ctype)
        img = np.cumsum(rng.integers(0, 40, (9, 13, channels)), axis=1).astype(np.uint8)
        got = decode_png(_encode_png(img, ctype, ftype))
        np.testing.assert_array_equal(got, img)

    def test_write_read_roundtrip(self, tmp_path):
        rng = np.random.default_rng(1)
        img = rng.integers(0, 256, (17, 23, 3)).astype(np.uint8)
        write_png(tmp_path / "a.png", img)
        np.testing.assert_array_equal(read_png(tmp_path / "a.png"), img / np.float32(255))

    def test_committed_normal_map(self):
        """scenes/assets/wave_normal.png (128x128 RGB, Sub/Up/Paeth rows):
        a unit-ish tangent-space normal field, +z dominant."""
        img = load_image(REPO / "scenes" / "assets" / "wave_normal.png")
        assert img.shape == (128, 128, 3)
        n = img * 2.0 - 1.0
        assert (n[..., 2] > 0.3).all()
        np.testing.assert_allclose(np.linalg.norm(n, axis=-1), 1.0, atol=0.03)

    def test_gray_expands_to_rgb(self, tmp_path):
        img = np.arange(12, dtype=np.uint8).reshape(3, 4, 1) * 20
        (tmp_path / "g.png").write_bytes(_encode_png(img, 0, 4))
        got = read_png(tmp_path / "g.png")
        assert got.shape == (3, 4, 3)
        np.testing.assert_array_equal(got[..., 1], img[..., 0] / np.float32(255))

    def test_unsupported_rejected(self):
        with pytest.raises(ValueError, match="not a PNG"):
            decode_png(b"GIF89a")


def test_hdr_roundtrip(tmp_path):
    img = np.random.default_rng(2).random((6, 10, 3)).astype(np.float32) * 50
    write_hdr(tmp_path / "e.hdr", img)
    got = read_hdr(tmp_path / "e.hdr")
    # RGBE keeps 8 mantissa bits against the pixel's largest channel
    scale = img.max(axis=-1, keepdims=True)
    assert (np.abs(got - img) <= scale * 2 ** -7).all()


class TestCompileCache:
    def test_env_var_wins(self, monkeypatch, tmp_path):
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
        assert jaxcache.cache_dir() == str(tmp_path / "c")

    def test_default_inside_checkout(self, monkeypatch):
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        d = Path(jaxcache.cache_dir())
        assert d == REPO / ".jax_cache"
        assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


class TestAssets:
    def test_deterministic_for_seed(self, tmp_path):
        a = assets.generate(tmp_path / "a", seed=7)
        b = assets.generate(tmp_path / "b", seed=7)
        c = assets.generate(tmp_path / "c", seed=8)
        for f in assets.FILES:
            assert (a / f).read_bytes() == (b / f).read_bytes(), f
        assert (a / "blob.obj").read_bytes() != (c / "blob.obj").read_bytes()

    def test_blob_is_a_closed_curved_mesh(self):
        verts, faces, normals = assets.blob_mesh()
        assert 10_000 <= len(faces) <= 20_000
        # closed 2-manifold: every edge is shared by exactly two faces
        e = np.sort(np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]],
                                    faces[:, [2, 0]]]), axis=1)
        _, counts = np.unique(e, axis=0, return_counts=True)
        assert (counts == 2).all()
        assert len(verts) - len(e) // 2 + len(faces) == 2  # Euler: sphere
        np.testing.assert_allclose(np.linalg.norm(normals, axis=1), 1.0, atol=1e-6)
        # no two neighbouring faces are coplanar (not a flat subdivision)
        tri = verts[faces]
        fn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
        fn /= np.linalg.norm(fn, axis=1, keepdims=True)
        assert np.abs(fn[0::2] @ np.ones(3) - fn[1::2] @ np.ones(3)).min() > 0

    def test_ensure_regenerates_on_stale_manifest(self, tmp_path):
        out = assets.ensure_assets(tmp_path)
        (out / "manifest.json").write_text(json.dumps({"version": -1}))
        (out / "texture.png").unlink()
        assets.ensure_assets(tmp_path)
        assert (out / "texture.png").is_file()
        assert json.loads((out / "manifest.json").read_text())["seed"] == assets.DEFAULT_SEED

    def test_scene_assets_resolve(self, scenes_dir):
        from pathtracer.scene.parser import load_scene

        scene = load_scene(scenes_dir / "glassbunny.txt")
        (key,) = scene.meshes
        assert Path(key).resolve() == (assets.ASSET_DIR / "blob.obj").resolve()

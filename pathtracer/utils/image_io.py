"""Image I/O: PNG and Radiance HDR readers and writers (numpy + zlib).

Replaces the reference's vendored stb_image/stb_image_write
(reference: src/image.cpp:22-79, src/stb.cpp).  Matches the reference's load
conventions:
- images are float32 RGB in [0, inf)
- LDR images are loaded with gamma 1.0 by default (the reference calls
  stbi_ldr_to_hdr_gamma(gamma) with gamma defaulting to 1.f,
  reference: src/scene.h:60, src/image.cpp:22-38) — i.e. NO sRGB→linear
  conversion, just /255
- textures are flipped vertically at load
  (stbi_set_flip_vertically_on_load(true), reference: src/scene.cpp:56)

PNG and HDR need nothing beyond numpy and zlib.  Other LDR formats (JPEG,
BMP, ...) are read through Pillow when it is installed.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np


def load_image(path: str | Path, gamma: float = 1.0, flip_vertical: bool = True) -> np.ndarray:
    """Load any supported image as float32 (H, W, 3)."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix == ".hdr":
        img = read_hdr(path)
    else:
        if suffix == ".png":
            arr = read_png(path)
        else:
            from PIL import Image  # optional: only non-PNG LDR formats

            with Image.open(path) as im:
                arr = np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0
        if gamma != 1.0:
            arr = np.power(arr, gamma)
        img = arr
    if flip_vertical:
        img = img[::-1].copy()
    return np.ascontiguousarray(img, dtype=np.float32)


# ---------------------------------------------------------------------------
# Radiance .hdr (RGBE) reader/writer


def read_hdr(path: str | Path) -> np.ndarray:
    """Decode a Radiance RGBE file (the format of scenes/env/*.hdr)."""
    data = Path(path).read_bytes()
    # header
    pos = 0
    if not data.startswith(b"#?"):
        raise ValueError("not a Radiance HDR file")
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line == b"":
            break
    # resolution line, e.g. "-Y 1024 +X 2048"
    eol = data.index(b"\n", pos)
    res = data[pos:eol].split()
    pos = eol + 1
    if res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"unsupported HDR orientation: {res}")
    height, width = int(res[1]), int(res[3])

    rgbe = np.zeros((height, width, 4), dtype=np.uint8)
    buf = np.frombuffer(data, dtype=np.uint8, offset=pos)
    bp = 0
    for y in range(height):
        if (
            width >= 8
            and width < 32768
            and buf[bp] == 2
            and buf[bp + 1] == 2
            and ((int(buf[bp + 2]) << 8) | int(buf[bp + 3])) == width
        ):
            # adaptive RLE: 4 channel-planes per scanline
            bp += 4
            for c in range(4):
                x = 0
                while x < width:
                    count = int(buf[bp])
                    bp += 1
                    if count > 128:  # run
                        rgbe[y, x : x + count - 128, c] = buf[bp]
                        bp += 1
                        x += count - 128
                    else:  # literal
                        rgbe[y, x : x + count, c] = buf[bp : bp + count]
                        bp += count
                        x += count
        else:
            # flat scanline (possibly old-style RLE, rare; handle flat only)
            row = buf[bp : bp + width * 4].reshape(width, 4)
            rgbe[y] = row
            bp += width * 4

    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 136)).astype(np.float32)
    # RGBE convention: v = (mantissa + 0.5?) — stb uses c * 2^(e-136) without
    # the +0.5 bias (matches stbi_loadf output for .hdr)
    return (rgbe[..., :3].astype(np.float32) * scale[..., None]).astype(np.float32)


def write_hdr(path: str | Path, img: np.ndarray) -> None:
    """Write float32 (H, W, 3) as uncompressed Radiance RGBE."""
    img = np.asarray(img, dtype=np.float32)
    h, w, _ = img.shape
    maxc = img.max(axis=-1)
    with np.errstate(divide="ignore"):
        exp = np.where(maxc > 1e-32, np.floor(np.log2(maxc)) + 1, 0).astype(np.int32)
    scale = np.where(maxc > 1e-32, np.ldexp(1.0, -exp) * 256.0, 0.0)
    rgbe = np.zeros((h, w, 4), dtype=np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(maxc > 1e-32, exp + 128, 0).astype(np.uint8)
    header = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode()
    Path(path).write_bytes(header + rgbe.tobytes())


# ---------------------------------------------------------------------------
# PNG writer (pure numpy + zlib; mirrors image::savePNG clamping,
# reference: src/image.cpp:56-73)


def write_png(path: str | Path, img: np.ndarray) -> None:
    """Write (H, W, 3) float in [0,1] (or uint8) as PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        out = struct.pack(">I", len(payload)) + tag + payload
        return out + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    Path(path).write_bytes(png)


_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # gray, RGB, gray+alpha, RGBA


def _unfilter_row(ftype: int, row: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """Undo one PNG scanline filter (RFC 2083 section 6); uint8 in/out."""
    if ftype == 0:
        return row
    if ftype == 1:  # Sub: running sum per channel
        return (np.cumsum(row.reshape(-1, bpp).astype(np.int64), axis=0) % 256
                ).astype(np.uint8).reshape(-1)
    if ftype == 2:  # Up
        return ((row.astype(np.int64) + prior) & 0xFF).astype(np.uint8)
    if ftype not in (3, 4):
        raise ValueError(f"PNG: unknown filter type {ftype}")
    out = row.astype(np.int64).tolist()
    up = prior.astype(np.int64).tolist()
    for i in range(len(out)):
        a = out[i - bpp] if i >= bpp else 0
        b = up[i]
        if ftype == 3:  # Average
            out[i] = (out[i] + ((a + b) >> 1)) & 0xFF
        else:  # Paeth
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            out[i] = (out[i] + pred) & 0xFF
    return np.asarray(out, np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """Decode an 8-bit, non-interlaced gray/RGB/gray+alpha/RGBA PNG into
    uint8 (H, W, C) with C = 1, 3, 2 or 4 channels."""
    if not data.startswith(b"\x89PNG\r\n\x1a\n"):
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        tag, body = data[pos + 4 : pos + 8], data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace:
        raise ValueError(
            f"PNG: unsupported format (bit depth {depth}, colour type "
            f"{ctype}, interlace {interlace}); 8-bit non-interlaced gray, "
            "RGB, gray+alpha and RGBA are supported"
        )
    bpp = _PNG_CHANNELS[ctype]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[: h * (stride + 1)].reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        prior = out[y] = _unfilter_row(int(raw[y, 0]), raw[y, 1:], prior, bpp)
    return out.reshape(h, w, bpp)


def read_png(path: str | Path) -> np.ndarray:
    """Read a PNG as float32 (H, W, 3) in [0,1]: gray is replicated to
    RGB and alpha is dropped (as PIL's convert("RGB") does)."""
    img = decode_png(Path(path).read_bytes())
    if img.shape[2] <= 2:  # gray or gray+alpha
        img = np.repeat(img[..., :1], 3, axis=2)
    return img[..., :3].astype(np.float32) / 255.0

"""Screenshot output (reference interactive_rendering.rs:1676-1714 +
game_world.rs:303-339: copy to host, clamp, auto-numbered PNG).

The counterpart of `wavefront_tpu.render.screenshot`.  The PNG is written
here with zlib and struct (an 8-bit RGB image, one IDAT chunk, filter 0 on
every row), so a screenshot needs no imaging package (the block
textures load through PIL, `world/blocks.py`); `read_png` reads such a
file back.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def to_srgb_bytes(img: np.ndarray) -> np.ndarray:
    """HDR float image -> clamped 8-bit (the reference's swapchain is UNORM:
    values clamp at 1.0 on store; no tone mapping, postprocess.rs:66)."""
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    body = kind + data
    return struct.pack(">I", len(data)) + body + struct.pack(
        ">I", zlib.crc32(body) & 0xFFFFFFFF)


def png_bytes(rgb: np.ndarray, level: int = 6) -> bytes:
    """An (H, W, 3) uint8 image as the bytes of a PNG file, deflated at
    zlib `level` (1 fastest, 9 smallest)."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"png_bytes: want (H, W, 3) uint8, got "
                         f"{rgb.shape} {rgb.dtype}")
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, -1)],
                          axis=1)
    # width, height, bit depth 8, color type 2 (RGB), deflate, filter
    # method 0, no interlace
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def read_png(data: bytes) -> np.ndarray:
    """The (H, W, 3) uint8 image of a PNG that `png_bytes` wrote: 8-bit
    RGB, not interlaced, filter 0 on every row.  Raises ValueError on
    any other PNG."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("read_png: not a PNG")
    pos, header, idat = 8, None, []
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None or header[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"read_png: header {header} is not 8-bit RGB")
    w, h = header[:2]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError("read_png: a row uses a filter other than 0")
    return rows[:, 1:].reshape(h, w, 3).copy()


def save_png(path: str, img: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png_bytes(to_srgb_bytes(img)))


def next_screenshot_path(directory: str = "screenshots") -> str:
    """Auto-numbering scheme of the reference (game_world.rs:310-327)."""
    os.makedirs(directory, exist_ok=True)
    next_idx = 0
    for name in os.listdir(directory):
        stem, ext = os.path.splitext(name)
        if ext.lower() == ".png":
            stem = stem.removeprefix("screenshot")
            if stem.isdigit():
                next_idx = max(next_idx, int(stem) + 1)
    return os.path.join(directory, f"{next_idx}.png")

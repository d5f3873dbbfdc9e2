"""Framebuffer and image output (port of ``rt_tpu.image``).

The reference's ``image`` (image.hpp:10-91) is an owning 64-byte-aligned
uint32 RGBA8888 buffer, blitted to screen via SDL (back_buffer.cpp:40-50).
The renderer produces float radiance on the device; this module adds what
the reference lacks: RGBA8888 packing plus PNG / PPM / NPY writers.  Every
writer takes a NumPy array or a torch tensor on any device (a tensor is
moved to the host first).  PNG encoding is plain ``zlib``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .colour import _host, pack_rgba8888, unpack_rgba8888

__all__ = ["Framebuffer", "to_rgba8888", "write_png", "write_ppm", "write_npy", "write_image"]


def to_rgba8888(img) -> np.ndarray:
    """Float (H, W, 3) radiance → uint32 RGBA8888 words (colour.hpp:100-106)."""
    return pack_rgba8888(img)


def _rgba_bytes(img) -> tuple[np.ndarray, int, int]:
    img = _host(img)
    if img.dtype == np.uint32:
        h, w = img.shape
        rgba = (unpack_rgba8888(img) * 255.0 + 0.5).astype(np.uint8)
    else:
        h, w = img.shape[:2]
        words = pack_rgba8888(img)
        rgba = np.stack(
            [(words >> 24) & 0xFF, (words >> 16) & 0xFF, (words >> 8) & 0xFF, words & 0xFF],
            axis=-1,
        ).astype(np.uint8)
    return rgba, w, h


def write_png(path: str, img) -> None:
    """Write a float (H, W, 3) or uint32 (H, W) image as RGBA PNG."""
    rgba, w, h = _rgba_bytes(img)
    raw = b"".join(b"\x00" + rgba[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


def write_ppm(path: str, img) -> None:
    """Binary PPM (P6), RGB only."""
    rgba, w, h = _rgba_bytes(img)
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(rgba[..., :3].tobytes())


def write_npy(path: str, img) -> None:
    np.save(path, _host(img))


def write_image(path: str, img) -> None:
    """Dispatch on extension: .png / .ppm / .npy."""
    if path.endswith(".png"):
        write_png(path, img)
    elif path.endswith(".ppm"):
        write_ppm(path, img)
    elif path.endswith(".npy"):
        write_npy(path, img)
    else:
        raise ValueError(f"unsupported image extension: {path}")


class Framebuffer:
    """Host-side uint32 RGBA8888 framebuffer (image.hpp:10-91 equivalent).

    Row-major, ``position_of(i) = (i % W, i // W)`` (image.hpp:82-85).
    Backed by a 64-byte-aligned numpy allocation like the reference's
    aligned_alloc (image.cpp:9-13).
    """

    def __init__(self, width: int, height: int):
        self.width = int(width)
        self.height = int(height)
        n = self.width * self.height
        backing = np.zeros(n + 16, dtype=np.uint32)
        off = (-backing.ctypes.data % 64) // 4
        self.pixels = backing[off : off + n].reshape(self.height, self.width)

    @property
    def size(self) -> tuple[int, int]:
        return (self.width, self.height)

    def position_of(self, idx: int) -> tuple[int, int]:
        return (idx % self.width, idx // self.width)

    def clear(self, value: int = 0x000000FF) -> None:
        """Fill with a packed colour; default opaque black (image.cpp:33-43)."""
        self.pixels[:] = value

    def blit(self, img) -> None:
        """Pack a float (H, W, 3) image into the buffer."""
        self.pixels[:] = to_rgba8888(img)

    def save(self, path: str) -> None:
        write_image(path, self.pixels)

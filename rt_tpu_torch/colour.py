"""Colour handling for rt_tpu_torch (port of ``rt_tpu.colour``).

Re-implements the behaviour of the reference's ``struct colour``
(the reference's colour.hpp:17-150) and its table of named web colours
(colour.hpp:181-333) on top of plain floats and NumPy arrays; the packers
also take torch tensors (moved to the host first).

Two reference quirks are preserved *faithfully* because image parity depends
on them:

1. **Integer component binarization.** ``colour::to_component_value``
   (colour.hpp:72-84) converts *any* non-float component by casting to float
   and clamping to [0, 1] — it never divides by 255.  Since every named colour
   is built from a ``0xRRGGBB_rgb`` literal whose channels are integers in
   [0, 255] (colour.hpp:154-176, 181-333), a named colour's channel is 1.0
   whenever the hex byte is non-zero and 0.0 otherwise.  E.g. ``gray_33``
   (0xAAAAAA) is actually (1, 1, 1, 1) == white at runtime, and ``crimson``
   (0xDC143C) is (1, 1, 1, 1) too.  We default to this behaviour
   (``compat=True``); pass ``compat=False`` for the /255 interpretation.

2. **Packing to RGBA8888** multiplies by 255.99999 after a [0, 1] clamp and
   truncates (colour.hpp:100-106).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "NAMED_COLOURS",
    "colour_from_hex",
    "colour_from_rgba_hex",
    "colour_from_argb_hex",
    "resolve_colour",
    "pack_rgba8888",
    "unpack_rgba8888",
]

# Named colours from colour.hpp:181-333 (htmlcolorcodes.com
# names), stored here as the raw 0xRRGGBB literals so both the compat
# (binarized) and true-colour (/255) interpretations can be derived.
_NAMED_HEX: dict[str, int] = {
    "alice_blue": 0xF0F8FF,
    "antique_white": 0xFAEBD7,
    "aqua": 0x00FFFF,
    "aquamarine": 0x7FFFD4,
    "azure": 0xF0FFFF,
    "beige": 0xF5F5DC,
    "bisque": 0xFFE4C4,
    "black": 0x000000,
    "blanched_almond": 0xFFEBCD,
    "blue": 0x0000FF,
    "blue_violet": 0x8A2BE2,
    "brown": 0xA52A2A,
    "burly_wood": 0xDEB887,
    "cadet_blue": 0x5F9EA0,
    "chartreuse": 0x7FFF00,
    "chocolate": 0xD2691E,
    "coral": 0xFF7F50,
    "cornflower_blue": 0x6495ED,
    "cornsilk": 0xFFF8DC,
    "crimson": 0xDC143C,
    "cyan": 0x00FFFF,
    "dark_blue": 0x00008B,
    "dark_cyan": 0x008B8B,
    "dark_goldenrod": 0xB8860B,
    "dark_gray": 0xA9A9A9,
    "dark_green": 0x006400,
    "dark_khaki": 0xBDB76B,
    "dark_magenta": 0x8B008B,
    "dark_olive_green": 0x556B2F,
    "dark_orange": 0xFF8C00,
    "dark_orchid": 0x9932CC,
    "dark_red": 0x8B0000,
    "dark_salmon": 0xE9967A,
    "dark_sea_green": 0x8FBC8B,
    "dark_slate_blue": 0x483D8B,
    "dark_slate_gray": 0x2F4F4F,
    "dark_turquoise": 0x00CED1,
    "dark_violet": 0x9400D3,
    "deep_pink": 0xFF1493,
    "deep_sky_blue": 0x00BFFF,
    "dim_gray": 0x696969,
    "dodger_blue": 0x1E90FF,
    "fire_brick": 0xB22222,
    "floral_white": 0xFFFAF0,
    "forest_green": 0x228B22,
    "fuchsia": 0xFF00FF,
    "gainsboro": 0xDCDCDC,
    "ghost_white": 0xF8F8FF,
    "gold": 0xFFD700,
    "goldenrod": 0xDAA520,
    "gray": 0x808080,
    "green": 0x008000,
    "green_yellow": 0xADFF2F,
    "honey_dew": 0xF0FFF0,
    "hot_pink": 0xFF69B4,
    "indian_red": 0xCD5C5C,
    "indigo": 0x4B0082,
    "ivory": 0xFFFFF0,
    "khaki": 0xF0E68C,
    "lavender": 0xE6E6FA,
    "lavender_blush": 0xFFF0F5,
    "lawn_green": 0x7CFC00,
    "lemon_chiffon": 0xFFFACD,
    "light_blue": 0xADD8E6,
    "light_coral": 0xF08080,
    "light_cyan": 0xE0FFFF,
    "light_goldenrod_yellow": 0xFAFAD2,
    "light_gray": 0xD3D3D3,
    "light_green": 0x90EE90,
    "light_pink": 0xFFB6C1,
    "light_salmon": 0xFFA07A,
    "light_sea_green": 0x20B2AA,
    "light_sky_blue": 0x87CEFA,
    "light_slate_gray": 0x778899,
    "light_steel_blue": 0xB0C4DE,
    "light_yellow": 0xFFFFE0,
    "lime": 0x00FF00,
    "lime_green": 0x32CD32,
    "linen": 0xFAF0E6,
    "magenta": 0xFF00FF,
    "maroon": 0x800000,
    "medium_aquamarine": 0x66CDAA,
    "medium_blue": 0x0000CD,
    "medium_orchid": 0xBA55D3,
    "medium_purple": 0x9370DB,
    "medium_sea_green": 0x3CB371,
    "medium_slate_blue": 0x7B68EE,
    "medium_spring_green": 0x00FA9A,
    "medium_turquoise": 0x48D1CC,
    "medium_violet_red": 0xC71585,
    "midnight_blue": 0x191970,
    "mint_cream": 0xF5FFFA,
    "misty_rose": 0xFFE4E1,
    "moccasin": 0xFFE4B5,
    "navajo_white": 0xFFDEAD,
    "navy": 0x000080,
    "old_lace": 0xFDF5E6,
    "olive": 0x808000,
    "olive_drab": 0x6B8E23,
    "orange": 0xFFA500,
    "orange_red": 0xFF4500,
    "orchid": 0xDA70D6,
    "pale_goldenrod": 0xEEE8AA,
    "pale_green": 0x98FB98,
    "pale_turquoise": 0xAFEEEE,
    "pale_violet_red": 0xDB7093,
    "papaya_whip": 0xFFEFD5,
    "peach_puff": 0xFFDAB9,
    "peru": 0xCD853F,
    "pink": 0xFFC0CB,
    "plum": 0xDDA0DD,
    "powder_blue": 0xB0E0E6,
    "purple": 0x800080,
    "rebecca_purple": 0x663399,
    "red": 0xFF0000,
    "rosy_brown": 0xBC8F8F,
    "royal_blue": 0x4169E1,
    "saddle_brown": 0x8B4513,
    "salmon": 0xFA8072,
    "sandy_brown": 0xF4A460,
    "sea_green": 0x2E8B57,
    "sea_shell": 0xFFF5EE,
    "sienna": 0xA0522D,
    "silver": 0xC0C0C0,
    "sky_blue": 0x87CEEB,
    "slate_blue": 0x6A5ACD,
    "slate_gray": 0x708090,
    "snow": 0xFFFAFA,
    "spring_green": 0x00FF7F,
    "steel_blue": 0x4682B4,
    "tan": 0xD2B48C,
    "teal": 0x008080,
    "thistle": 0xD8BFD8,
    "tomato": 0xFF6347,
    "turquoise": 0x40E0D0,
    "violet": 0xEE82EE,
    "wheat": 0xF5DEB3,
    "white": 0xFFFFFF,
    "white_smoke": 0xF5F5F5,
    "yellow": 0xFFFF00,
    "yellow_green": 0x9ACD32,
    # the "gray-dient" block, colour.hpp:325-331
    "gray_87": 0x202020,
    "gray_75": 0x404040,
    "gray_67": 0x555555,
    "gray_50": 0x808080,
    "gray_33": 0xAAAAAA,
    "gray_25": 0xC0C0C0,
    # "funsies", colour.hpp:333-334
    "portal_blue": 0x0078FF,
    "portal_orange": 0xFD6600,
}

NAMED_COLOURS = frozenset(_NAMED_HEX)


def _component_compat(byte_val: int) -> float:
    """Reference integer→float component conversion (colour.hpp:72-84):
    cast to float, clamp to [0, 1].  NOT a /255 — see module docstring."""
    return min(max(float(byte_val), 0.0), 1.0)


def colour_from_hex(rgb_hex: int, *, compat: bool = True) -> tuple[float, float, float, float]:
    """Build an RGBA tuple from a 0xRRGGBB literal, mirroring the ``_rgb``
    UDL (colour.hpp:165-169) + ``colour(uint32_t)`` ctor (colour.hpp:93-99)."""
    r = (rgb_hex >> 16) & 0xFF
    g = (rgb_hex >> 8) & 0xFF
    b = rgb_hex & 0xFF
    if compat:
        return (_component_compat(r), _component_compat(g), _component_compat(b), 1.0)
    return (r / 255.0, g / 255.0, b / 255.0, 1.0)


def colour_from_rgba_hex(rgba_hex: int, *, compat: bool = True) -> tuple[float, float, float, float]:
    """0xRRGGBBAA literal → RGBA tuple (the ``_rgba`` UDL, colour.hpp:158-162)."""
    comps = [(rgba_hex >> s) & 0xFF for s in (24, 16, 8, 0)]
    if compat:
        return tuple(_component_compat(c) for c in comps)
    return tuple(c / 255.0 for c in comps)


def colour_from_argb_hex(argb_hex: int, *, compat: bool = True) -> tuple[float, float, float, float]:
    """0xAARRGGBB literal → RGBA tuple (the ``_argb`` UDL, colour.hpp:171-176)."""
    a = (argb_hex >> 24) & 0xFF
    rgb = argb_hex & 0xFFFFFF
    return colour_from_rgba_hex((rgb << 8) | a, compat=compat)


def resolve_colour(value, *, compat: bool = True) -> tuple[float, float, float, float]:
    """Resolve a TOML colour value → RGBA float tuple.

    Accepts the same inputs as the reference deserializer
    (the reference's scene.cpp:187-357):
      - a named-colour string ("gray_33", "fuchsia", ...)
      - an array of up to 4 numeric components; missing alpha defaults to 1
        (scene.cpp:347-356); float components are used as-is, integer
        components go through the clamp conversion.
    """
    if isinstance(value, str):
        try:
            return colour_from_hex(_NAMED_HEX[value], compat=compat)
        except KeyError:
            raise ValueError(f"unknown colour alias '{value}'") from None
    if isinstance(value, (int, float)):
        raise ValueError(f"no mapping from scalar {value!r} to colour")
    vals = [0.0, 0.0, 0.0, 0.0]
    seq = list(value)
    if len(seq) > 4:
        raise ValueError(f"colour array has {len(seq)} components (max 4)")
    for i, c in enumerate(seq):
        if isinstance(c, bool):
            raise ValueError("boolean is not a colour component")
        if isinstance(c, int):
            # Integral components go through the clamp conversion like the
            # reference's to_component_value (colour.hpp:72-84).
            vals[i] = _component_compat(c) if compat else c / 255.0
        elif isinstance(c, float):
            vals[i] = min(max(c, 0.0), 1.0)
        else:
            raise ValueError(f"bad colour component {c!r}")
    if len(seq) < 4:
        vals[3] = 1.0
    return tuple(vals)


def _host(x) -> np.ndarray:
    """A NumPy view of ``x``; a torch tensor is moved to the host first."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def pack_rgba8888(rgb, alpha: float = 1.0):
    """Pack a float image (..., 3) into uint32 RGBA8888 words.

    Mirrors ``colour::operator uint32_t`` (colour.hpp:100-106): clamp to
    [0, 1], scale by 255.99999, truncate, then (r<<24)|(g<<16)|(b<<8)|a.
    Host-side op (runs after the device render).
    """
    rgb = _host(rgb).astype(np.float32, copy=False)
    a = np.full(rgb.shape[:-1] + (1,), alpha, dtype=np.float32)
    rgba = np.concatenate([rgb, a], axis=-1)
    q = (np.clip(rgba, 0.0, 1.0) * 255.99999).astype(np.uint32)
    return (q[..., 0] << 24) | (q[..., 1] << 16) | (q[..., 2] << 8) | q[..., 3]


def unpack_rgba8888(words):
    """Inverse of :func:`pack_rgba8888` → float32 (..., 4) in [0, 1]."""
    words = _host(words).astype(np.uint32, copy=False)
    out = np.stack(
        [
            (words >> 24) & 0xFF,
            (words >> 16) & 0xFF,
            (words >> 8) & 0xFF,
            words & 0xFF,
        ],
        axis=-1,
    ).astype(np.float32)
    return out / 255.0

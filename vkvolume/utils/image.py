"""Image output helpers (PNG snapshots; replaces the swapchain present).

The PNG encoder needs only numpy and the standard library's zlib."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def composite_over(rgba: np.ndarray, background=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Premultiplied rgba over a constant background → float rgb."""
    rgba = np.asarray(rgba, np.float32)
    bg = np.asarray(background, np.float32)
    return rgba[..., :3] + (1.0 - rgba[..., 3:4]) * bg


def to_u8(rgb: np.ndarray) -> np.ndarray:
    return np.clip(np.round(np.asarray(rgb, np.float32) * 255.0), 0, 255).astype(
        np.uint8
    )


# PNG colour type per channel count (PNG spec, IHDR): gray, RGB, RGBA.
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}


def encode_png(img: np.ndarray) -> bytes:
    """8-bit PNG bytes of an (H, W), (H, W, 1), (H, W, 3) or (H, W, 4)
    uint8 image: one IDAT chunk, filter type 0 on every row."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        raise ValueError(f"encode_png needs uint8 pixels, got {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.ndim != 3 or arr.shape[-1] not in _COLOR_TYPE:
        raise ValueError(f"unsupported image shape {arr.shape}")
    h, w, c = arr.shape
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), arr.reshape(h, w * c)], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def write_png(path: str, rgb_or_rgba: np.ndarray) -> None:
    """Write a PNG snapshot. Float input is a [0, 1] image; float RGBA is
    premultiplied and composited over black first."""
    arr = np.asarray(rgb_or_rgba)
    if arr.dtype != np.uint8:
        if arr.ndim == 3 and arr.shape[-1] == 4:
            arr = to_u8(composite_over(arr))
        else:
            arr = to_u8(arr)
    with open(path, "wb") as fh:
        fh.write(encode_png(arr))

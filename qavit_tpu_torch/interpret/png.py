"""Overlay images without matplotlib or PIL, which the card's machine
lacks: matplotlib's ``jet`` colormap rebuilt from its piecewise-linear
segment data (``matplotlib._cm._jet_data``, a 256-entry lookup table made
as ``LinearSegmentedColormap`` makes it) and an RGB PNG writer on
``zlib`` and ``struct``."""

from __future__ import annotations

import struct
import zlib

import numpy as np

# (x, y0, y1) breakpoints of each channel, matplotlib's _jet_data
_JET = {
    "red": ((0.00, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1),
            (1.00, 0.5, 0.5)),
    "green": ((0.000, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.640, 1, 1),
              (0.910, 0, 0), (1.000, 0, 0)),
    "blue": ((0.00, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0),
             (1.00, 0, 0)),
}
N = 256


def _lookup_table(data, n: int = N) -> np.ndarray:
    """matplotlib.colors._create_lookup_table for segment data."""
    a = np.asarray(data, dtype=float)
    x, y0, y1 = a[:, 0] * (n - 1), a[:, 1], a[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]],
                          distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1],
                          [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


JET_LUT = np.stack([_lookup_table(_JET[c]) for c in ("red", "green",
                                                     "blue")], axis=1)


def jet(values: np.ndarray) -> np.ndarray:
    """``matplotlib.cm.jet(values)[..., :3]`` for floats in [0, 1]: the
    table entry floor(v * 256), 1.0 in the last one; below 0 the first
    entry, above 1 the last (jet's under and over colours)."""
    xa = np.array(values, copy=True)
    xa *= N
    xa[xa == N] = N - 1
    np.clip(xa, -1, N, out=xa)
    idx = np.clip(xa.astype(int), 0, N - 1)
    return JET_LUT[idx]


def heat_and_overlay(cam: np.ndarray, image_u8: np.ndarray):
    """The Grad-CAM pair (``test_hqa.py:281-318``): the jet heatmap and
    its 0.5-alpha blend with the image, both uint8 [H, W, 3]."""
    heat = (jet(cam) * 255).astype(np.uint8)
    overlay = (0.5 * heat + 0.5 * image_u8).astype(np.uint8)
    return heat, overlay


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, rgb: np.ndarray) -> None:
    """An 8-bit RGB PNG of ``rgb`` [H, W, 3] uint8 (no filtering)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"write_png takes [H, W, 3] uint8, got {rgb.shape}")
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           rgb.reshape(h, 3 * w)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                            0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))

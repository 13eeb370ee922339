"""Animated PNG (APNG) writer + hourly map animation.

The GUI shows output maps updating hour by hour as the model runs
(mainwindow.cpp refreshing the mapGraphics canvas per
Crit3DProject::modelHourlyCycle).  Headless, the same capability is an
APNG: one self-contained file, every browser plays it, pure stdlib
zlib like the rest of viz/.  The APNG container follows the PNG
third-edition spec (acTL / fcTL / fdAT chunks).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from criteria3d_tpu_torch.constants import NODATA
from criteria3d_tpu_torch.viz.mapview import render_map

__all__ = ["write_apng", "animate_maps"]


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def _idat_payload(rgba: np.ndarray) -> bytes:
    h = rgba.shape[0]
    raw = b"".join(b"\x00" + rgba[r].tobytes() for r in range(h))
    return zlib.compress(raw, 6)


def write_apng(path, frames, delay_ms: int = 400, loops: int = 0) -> None:
    """Write an animated PNG from (H, W, 4) uint8 frames (equal shapes).

    ``loops=0`` plays forever. A single frame degrades to a plain PNG
    (no animation chunks), so callers don't need to special-case.
    """
    frames = [np.ascontiguousarray(f.rgba if hasattr(f, "rgba") else f,
                                   dtype=np.uint8) for f in frames]
    if not frames:
        raise ValueError("no frames")
    h, w = frames[0].shape[:2]
    for f in frames:
        if f.shape != frames[0].shape:
            raise ValueError("all frames must share one shape")
    out = [b"\x89PNG\r\n\x1a\n",
           _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))]
    if len(frames) > 1:
        out.append(_chunk(b"acTL", struct.pack(">II", len(frames), loops)))
    seq = 0
    for i, fr in enumerate(frames):
        if len(frames) > 1:
            out.append(_chunk(b"fcTL", struct.pack(
                ">IIIIIHHBB", seq, w, h, 0, 0, delay_ms, 1000, 0, 0)))
            seq += 1
        data = _idat_payload(fr)
        if i == 0:
            out.append(_chunk(b"IDAT", data))
        else:
            out.append(_chunk(b"fdAT", struct.pack(">I", seq) + data))
            seq += 1
    out.append(_chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(b"".join(out))


def animate_maps(path, dem: np.ndarray, cell_size: float, rasters,
                 *, labels=None, overlay_scale: str = "surface_water",
                 header=None, points=None, target_width: int = 560,
                 delay_ms: int = 400, nodata=NODATA) -> int:
    """Render a raster sequence over the shaded DEM into one APNG.

    ``rasters`` is an iterable of (R, C) overlay fields (one per frame,
    e.g. hourly ponding); the color range is fixed to the global
    min/max across ALL frames so colors are comparable hour to hour.
    Returns the frame count.
    """
    rasters = [np.asarray(r, np.float64) for r in rasters]
    if not rasters:
        raise ValueError("no rasters")
    lo, hi = np.inf, -np.inf
    for r in rasters:
        v = r[np.isfinite(r) & ~np.isclose(r, nodata)]
        if v.size:
            lo, hi = min(lo, float(v.min())), max(hi, float(v.max()))
    if not np.isfinite(lo):
        lo, hi = 0.0, 1.0
    frames = []
    for i, r in enumerate(rasters):
        title = (labels[i] if labels is not None else f"H+{i}")
        frames.append(render_map(dem, cell_size, header=header, overlay=r,
                                 overlay_scale=overlay_scale,
                                 overlay_vmin=lo, overlay_vmax=hi,
                                 points=points, title=str(title),
                                 target_width=target_width,
                                 nodata=nodata))
    write_apng(path, frames, delay_ms=delay_ms)
    return len(frames)

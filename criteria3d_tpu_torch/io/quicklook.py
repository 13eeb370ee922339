"""Headless color-scale PNG quick-look rendering of output rasters.

The port's own copy of ``criteria3d_tpu/io/quicklook.py``, line for line
(host numpy; the same PNG bytes for the same arrays).

The framework's answer to "no GUI": any (R, C) raster (DEM, output map,
interpolated meteo field) renders to a PNG with the reference's own color
scales (agrolib/gis/color.cpp:218-413 — the key-color tables and the
EqualInterval classify() interpolation, Crit3DColorScale::classify,
color.cpp:93-121).  Pure stdlib: the PNG container is written directly
(zlib deflate, RGBA), no matplotlib/PIL dependency.

Used by the CLI ``EXPORTPNG`` command (cli.py) and directly::

    from criteria3d_tpu_torch.io.quicklook import write_png_raster
    write_png_raster("dem.png", dem, scale="dtm", nodata=-9999)
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from criteria3d_tpu_torch.constants import NODATA

__all__ = ["COLOR_SCALES", "classify_colors", "render_rgba",
           "write_png", "write_png_raster"]

# key-color tables (color.cpp:218-413); 256 interpolated colors each
COLOR_SCALES = {
    "default": [(0, 0, 255), (64, 196, 64), (255, 255, 0), (255, 0, 0)],
    "dtm": [(32, 160, 32), (224, 224, 0), (160, 64, 0), (224, 224, 224)],
    "lai": [(200, 160, 0), (160, 160, 0), (32, 160, 32), (0, 255, 0)],
    "temperature": [(0, 0, 255), (64, 196, 64), (255, 255, 0),
                    (255, 0, 0), (128, 0, 128)],
    "slope_stability": [(0, 0, 0), (128, 0, 128), (255, 0, 0),
                        (255, 255, 0), (64, 196, 64)],
    "anomaly": [(0, 0, 255), (64, 196, 64), (255, 255, 255),
                (255, 0, 0), (128, 0, 128)],
    "precipitation": [(255, 255, 255), (0, 0, 255), (64, 196, 64),
                      (255, 255, 0), (255, 0, 0), (128, 0, 128)],
    "centered": [(0, 0, 255), (64, 196, 64), (255, 255, 255),
                 (255, 255, 0), (255, 0, 0)],
    "circular": [(0, 0, 255), (255, 255, 0), (255, 0, 0),
                 (0, 255, 0), (0, 0, 255)],
    "relative_humidity": [(128, 0, 0), (255, 255, 0), (0, 0, 255)],
    "wind_intensity": [(32, 128, 32), (255, 255, 0), (255, 0, 0)],
    "radiation": [(0, 0, 255), (255, 255, 0), (255, 0, 0), (128, 0, 128)],
    "surface_water": [(255, 255, 255), (0, 255, 255), (0, 0, 255),
                      (128, 0, 255), (255, 0, 0)],
    "gray": [(0, 0, 0), (255, 255, 255)],
}


def classify_colors(scale="default", n_colors=256) -> np.ndarray:
    """(n_colors, 3) uint8 lookup via the reference's EqualInterval
    interpolation (Crit3DColorScale::classify, color.cpp:93-121):
    nrStep = n // (nKey-1) truncated, last remainder pinned to the final
    key color."""
    keys = np.asarray(COLOR_SCALES[scale], np.float64)
    n_int = max(len(keys) - 1, 1)
    step = n_colors // n_int
    out = np.empty((n_colors, 3), np.uint8)
    for i in range(n_int):
        d = (keys[i + 1] - keys[i]) / step
        for j in range(step):
            out[step * i + j] = (keys[i] + (d * j).astype(np.int16)
                                 ).astype(np.uint8)
    out[step * n_int:] = keys[-1].astype(np.uint8)
    return out


def render_rgba(data, scale="default", *, vmin=None, vmax=None,
                nodata=NODATA) -> np.ndarray:
    """(R, C, 4) uint8 image; nodata cells transparent."""
    a = np.asarray(data, np.float64)
    valid = np.isfinite(a) & ~np.isclose(a, nodata)
    vals = a[valid]
    if vmin is None:
        vmin = float(vals.min()) if vals.size else 0.0
    if vmax is None:
        vmax = float(vals.max()) if vals.size else 1.0
    lut = classify_colors(scale)
    span = max(vmax - vmin, 1e-30)
    idx = np.clip(((a - vmin) / span * (len(lut) - 1)), 0,
                  len(lut) - 1).astype(np.int32)
    rgba = np.zeros(a.shape + (4,), np.uint8)
    rgba[..., :3] = lut[idx]
    rgba[..., 3] = np.where(valid, 255, 0)
    return rgba


def write_png(path, rgba: np.ndarray) -> None:
    """Minimal RGBA PNG writer (8-bit, no interlace)."""
    h, w = rgba.shape[:2]

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + rgba[r].tobytes() for r in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def write_png_raster(path, data, scale="default", *, vmin=None, vmax=None,
                     nodata=NODATA, legend=True) -> dict:
    """Render ``data`` with a named color scale and write a PNG.

    ``legend=True`` appends a 12-px horizontal color bar under the map.
    Returns {"vmin": ..., "vmax": ...} (the range actually used)."""
    a = np.asarray(data, np.float64)
    valid = np.isfinite(a) & ~np.isclose(a, nodata)
    vals = a[valid]
    lo = float(vals.min()) if vals.size and vmin is None else (vmin or 0.0)
    hi = float(vals.max()) if vals.size and vmax is None else (vmax or 1.0)
    rgba = render_rgba(a, scale, vmin=lo, vmax=hi, nodata=nodata)
    if legend:
        lut = classify_colors(scale)
        w = rgba.shape[1]
        bar_idx = np.clip((np.arange(w) / max(w - 1, 1)
                           * (len(lut) - 1)).astype(np.int32), 0,
                          len(lut) - 1)
        bar = np.zeros((14, w, 4), np.uint8)
        bar[2:, :, :3] = lut[bar_idx][None, :, :]
        bar[2:, :, 3] = 255
        rgba = np.concatenate([rgba, bar], axis=0)
    write_png(path, rgba)
    return dict(vmin=lo, vmax=hi)

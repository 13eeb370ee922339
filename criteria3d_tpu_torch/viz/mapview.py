"""Map composites — the mapGraphics canvas analogue, headless.

The reference GUI shows rasters on a map canvas (mapGraphics
RasterObject + Crit3DColorScale) with meteo-point markers and a color
legend (mainwindow.cpp).  :func:`render_map` produces the same picture
as a PNG: a slope-shaded DEM base (the 3-D viewer's shadowDtmColor
formula, criteria3DProject.cpp:3370-3392, reads identically in 2-D as a
hillshade), an optional semi-transparent output-variable overlay, station
markers, a labeled color bar and a title.
"""

from __future__ import annotations

import numpy as np

from criteria3d_tpu_torch.constants import NODATA
from criteria3d_tpu_torch.core.grid import slope_aspect
from criteria3d_tpu_torch.io.quicklook import classify_colors, render_rgba
from criteria3d_tpu_torch.viz.canvas import Canvas

__all__ = ["hillshade_rgb", "render_map"]


def _range_labels(lo: float, hi: float) -> tuple[str, str]:
    """Format a (lo, hi) pair with enough digits to tell them apart."""
    for sig in (4, 6, 8, 10, 12):
        a, b = f"{lo:.{sig}g}", f"{hi:.{sig}g}"
        if a != b or lo == hi:
            return a, b
    return a, b


def hillshade_rgb(dem: np.ndarray, cell_size: float, scale: str = "dtm",
                  vmin=None, vmax=None, nodata=NODATA) -> np.ndarray:
    """(R, C, 4) slope-shaded DEM colors.

    Color from the named quicklook scale; shading is the reference's
    shadowDtmColor (criteria3DProject.cpp:3384-3389): an additive term
    ``-cos(aspect) * max(6, slope_deg * 120 / max(slope_max, 1))`` so
    north-facing slopes brighten and south-facing darken, amplified on
    flat catchments so relief stays legible.
    """
    rgba = render_rgba(dem, scale, vmin=vmin, vmax=vmax, nodata=nodata)
    slope, aspect = slope_aspect(np.asarray(dem, np.float64), cell_size)
    valid = ~np.isclose(slope, nodata) & ~np.isclose(aspect, nodata)
    slope_max = float(np.max(np.where(valid, slope, 0.0), initial=0.0))
    amp = 120.0 / max(slope_max, 1.0)
    shadow = -np.cos(np.radians(aspect)) * np.maximum(6.0, slope * amp)
    shadow = np.where(valid, shadow, 0.0)[..., None]
    rgb = np.clip(rgba[..., :3].astype(np.float64) + shadow, 0, 255)
    rgba[..., :3] = rgb.astype(np.uint8)
    return rgba


def _zoom_rgba(rgba: np.ndarray, target_width: int) -> tuple[np.ndarray, float]:
    """Integer-upscale (np.kron) or stride-decimate to ~target_width."""
    w = rgba.shape[1]
    if w <= 0:
        return rgba, 1.0
    if w < target_width:
        k = max(int(round(target_width / w)), 1)
        out = np.kron(rgba, np.ones((k, k, 1), np.uint8)) if k > 1 else rgba
        return out, float(k)
    step = int(np.ceil(w / target_width))
    return rgba[::step, ::step], 1.0 / step


def render_map(dem: np.ndarray, cell_size: float = 1.0, *, header=None,
               overlay: np.ndarray | None = None,
               overlay_scale: str = "default", overlay_alpha: float = 0.75,
               overlay_vmin=None, overlay_vmax=None,
               dem_scale: str = "dtm", points=None, title: str = "",
               target_width: int = 720, nodata=NODATA) -> Canvas:
    """Compose a shaded map view; returns a :class:`Canvas`.

    ``overlay`` is an (R, C) output raster draped over the DEM at
    ``overlay_alpha`` where valid.  ``points`` is an iterable of
    ``(utm_x, utm_y)`` / ``(utm_x, utm_y, label)`` tuples or objects with
    ``utm_x``/``utm_y`` attributes (e.g. MeteoStation); placing them
    needs ``header`` (io.esri.RasterHeader).  The legend bar is labeled
    with the overlay range (or the DEM range when no overlay).
    """
    dem = np.asarray(dem, np.float64)
    if header is not None:
        cell_size = header.cellsize
    base = hillshade_rgb(dem, cell_size, dem_scale, nodata=nodata)

    ov_range = None
    if overlay is not None:
        ov = np.asarray(overlay, np.float64)
        o_valid = np.isfinite(ov) & ~np.isclose(ov, nodata)
        vals = ov[o_valid]
        lo = float(vals.min()) if vals.size and overlay_vmin is None \
            else (overlay_vmin if overlay_vmin is not None else 0.0)
        hi = float(vals.max()) if vals.size and overlay_vmax is None \
            else (overlay_vmax if overlay_vmax is not None else 1.0)
        ov_rgba = render_rgba(ov, overlay_scale, vmin=lo, vmax=hi,
                              nodata=nodata)
        ov_rgba[..., 3] = (ov_rgba[..., 3].astype(np.float64)
                           * overlay_alpha).astype(np.uint8)
        a = ov_rgba[..., 3:4].astype(np.float64) / 255.0
        mix = ov_rgba[..., :3] * a + base[..., :3] * (1 - a)
        base[..., :3] = np.round(mix).astype(np.uint8)
        ov_range = (lo, hi)

    img, zoom = _zoom_rgba(base, target_width)
    h, w = img.shape[:2]
    top = 22 if title else 0
    legend_h = 30
    cv = Canvas(w, h + top + legend_h, background=(255, 255, 255, 255))
    if title:
        cv.text(w // 2, 7, title, scale=2 if w > 500 else 1, anchor="n")
    cv.blit(0, top, img)

    if points is not None and header is not None:
        for p in points:
            if hasattr(p, "utm_x"):
                x, y, label = p.utm_x, p.utm_y, getattr(p, "name", "")
            else:
                x, y = p[0], p[1]
                label = p[2] if len(p) > 2 else ""
            col = (x - header.xllcorner) / header.cellsize - 0.5
            row = header.nrows - 1 - ((y - header.yllcorner)
                                      / header.cellsize - 0.5)
            # map to the CENTER of the zoomed k-by-k pixel block, not its
            # NW corner — at high zoom the corner drifts ~k/2 px northwest
            # of the georeferenced cell
            px = int(round((col + 0.5) * zoom - 0.5))
            py = int(round((row + 0.5) * zoom - 0.5)) + top
            cv.marker(px, py, (220, 40, 40), size=7, shape="circle")
            if label:
                cv.text(px + 6, py - 3, str(label), scale=1)

    # legend bar labeled with the active (overlay, else DEM) range
    if ov_range is None:
        d_valid = np.isfinite(dem) & ~np.isclose(dem, nodata)
        vals = dem[d_valid]
        ov_range = (float(vals.min()) if vals.size else 0.0,
                    float(vals.max()) if vals.size else 1.0)
        bar_scale = dem_scale
    else:
        bar_scale = overlay_scale
    lut = classify_colors(bar_scale)
    bar_w = max(w - 140, 40)
    idx = np.clip((np.arange(bar_w) / max(bar_w - 1, 1)
                   * (len(lut) - 1)).astype(np.int32), 0, len(lut) - 1)
    bar = np.zeros((12, bar_w, 4), np.uint8)
    bar[..., :3] = lut[idx][None, :, :]
    bar[..., 3] = 255
    y0 = h + top + 9
    cv.blit(66, y0, bar)
    cv.frame_rect(66, y0, bar_w, 12, (0, 0, 0))
    lab_lo, lab_hi = _range_labels(*ov_range)
    cv.text(62, y0 + 3, lab_lo, anchor="ne")
    cv.text(66 + bar_w + 4, y0 + 3, lab_hi)
    return cv

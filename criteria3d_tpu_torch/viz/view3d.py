"""Headless 3-D terrain view — the bin/CRITERIA3D OpenGL viewer analogue.

The reference viewer (viewer3d.cpp + glWidget.cpp) builds two triangles
per DEM cell (criteria3DProject.cpp:3300-3367), colors vertices from the
DEM color scale shaded by slope/aspect (shadowDtmColor,
criteria3DProject.cpp:3370-3392), applies X/Z rotation + vertical
magnify (geometry.cpp), and rasterizes through OpenGL.  Headless, the
same scene renders in numpy: per-cell vertex positions and shaded
colors, a Z-then-X rotation, orthographic projection, and a z-buffered
splat rasterizer (depth test per pixel, exactly what GL_DEPTH_TEST does
for these cell-sized fragments) — no GL, no display.

An output raster can be draped over the terrain (``overlay``), matching
the GUI's "view variable in 3D" mode.
"""

from __future__ import annotations

import numpy as np

from criteria3d_tpu_torch.constants import NODATA
from criteria3d_tpu_torch.core.grid import slope_aspect
from criteria3d_tpu_torch.io.quicklook import render_rgba
from criteria3d_tpu_torch.viz.canvas import Canvas

__all__ = ["render_surface3d"]


def _fill_nodata(z: np.ndarray, valid: np.ndarray, iters: int = 64):
    """Flood nodata cells with the mean of valid neighbours (so bilinear
    refinement near the rim has finite support)."""
    z = np.where(valid, z, 0.0)
    v = valid.copy()
    for _ in range(iters):
        if v.all():
            break
        zp = np.pad(z, 1, mode="edge")
        vp = np.pad(v, 1, mode="edge").astype(np.float64)
        acc = np.zeros_like(z)
        cnt = np.zeros_like(z)
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                if di == 0 and dj == 0:
                    continue
                acc += (zp * vp)[1 + di:zp.shape[0] - 1 + di,
                                 1 + dj:zp.shape[1] - 1 + dj]
                cnt += vp[1 + di:zp.shape[0] - 1 + di,
                          1 + dj:zp.shape[1] - 1 + dj]
        new = ~v & (cnt > 0)
        z = np.where(new, acc / np.maximum(cnt, 1.0), z)
        v = v | new
    return z


def _refine(dem: np.ndarray, valid: np.ndarray, f: int):
    """Bilinear f-times upsample of the DEM (nodata flooded first, mask
    nearest-sampled) so screen-space splats stay seam-free when one cell
    projects to many pixels."""
    z = _fill_nodata(dem, valid)
    R, C = z.shape
    ri = np.clip((np.arange(R * f) + 0.5) / f - 0.5, 0, R - 1)
    ci = np.clip((np.arange(C * f) + 0.5) / f - 0.5, 0, C - 1)
    r0 = np.floor(ri).astype(int)
    c0 = np.floor(ci).astype(int)
    r1 = np.minimum(r0 + 1, R - 1)
    c1 = np.minimum(c0 + 1, C - 1)
    fr = (ri - r0)[:, None]
    fc = (ci - c0)[None, :]
    z_up = (z[np.ix_(r0, c0)] * (1 - fr) * (1 - fc)
            + z[np.ix_(r1, c0)] * fr * (1 - fc)
            + z[np.ix_(r0, c1)] * (1 - fr) * fc
            + z[np.ix_(r1, c1)] * fr * fc)
    rn = np.clip(np.round(ri).astype(int), 0, R - 1)
    cn = np.clip(np.round(ci).astype(int), 0, C - 1)
    v_up = valid[np.ix_(rn, cn)]
    return np.where(v_up, z_up, NODATA), v_up


def _shaded_colors(dem, cell_size, scale, nodata) -> np.ndarray:
    """Vertex colors: color scale + shadowDtmColor slope shading
    (criteria3DProject.cpp:3384-3389)."""
    rgba = render_rgba(dem, scale, nodata=nodata)
    slope, aspect = slope_aspect(np.asarray(dem, np.float64), cell_size)
    ok = ~np.isclose(slope, nodata)
    slope_max = float(np.max(np.where(ok, slope, 0.0), initial=0.0))
    amp = 120.0 / max(slope_max, 1.0)
    shadow = np.where(ok, -np.cos(np.radians(aspect))
                      * np.maximum(6.0, slope * amp), 0.0)
    rgb = np.clip(rgba[..., :3].astype(np.float64) + shadow[..., None],
                  0, 255)
    rgba[..., :3] = rgb.astype(np.uint8)
    return rgba


def render_surface3d(dem: np.ndarray, cell_size: float = 1.0, *,
                     overlay: np.ndarray | None = None,
                     overlay_scale: str = "default",
                     overlay_alpha: float = 0.85,
                     dem_scale: str = "dtm", magnify: float | None = None,
                     rotation_deg: float = 0.0, tilt_deg: float = 55.0,
                     width: int = 800, height: int = 600,
                     title: str = "", max_cells: int = 500_000,
                     nodata=NODATA) -> Canvas:
    """Render the DEM surface obliquely; returns a :class:`Canvas`.

    ``rotation_deg`` spins the scene about the vertical axis (the
    viewer's Z slider); ``tilt_deg`` tips it toward the camera (90 -
    xRotation in the viewer, 0 = top-down); ``magnify`` is the vertical
    exaggeration (auto: z-range drawn at ~15% of the horizontal extent,
    the slider's role in viewer3d.cpp).
    """
    dem = np.asarray(dem, np.float64)
    valid = np.isfinite(dem) & ~np.isclose(dem, nodata)
    if not valid.any():
        cv = Canvas(width, height)
        cv.text(width // 2, height // 2, "EMPTY DEM", anchor="center")
        return cv

    # decimate large DEMs so the splat buffers stay small
    step = 1
    while (dem.shape[0] // step) * (dem.shape[1] // step) > max_cells:
        step += 1
    if step > 1:
        dem = dem[::step, ::step]
        valid = valid[::step, ::step]
        cell_size = cell_size * step
    ov = (np.asarray(overlay, np.float64)[::step, ::step]
          if overlay is not None else None)

    # refine small DEMs whose cells project to many pixels, so the splat
    # footprint (capped below) still tiles the surface without seams
    R, C = dem.shape
    pad = 20
    t_est = np.radians(tilt_deg)
    s_est = min((width - 2 * pad) / max(C * cell_size, 1e-9),
                (height - 2 * pad) / max(R * cell_size
                                         * max(np.cos(t_est), 0.3), 1e-9))
    k_est = cell_size * s_est
    if k_est > 5.0:
        f = int(np.ceil(k_est / 5.0))
        f = min(f, max(int(np.sqrt(max_cells / max(R * C, 1))), 1))
        if f > 1:
            dem, valid = _refine(dem, valid, f)
            if ov is not None:
                rn = np.clip(np.round((np.arange(R * f) + 0.5) / f - 0.5)
                             .astype(int), 0, R - 1)
                cn = np.clip(np.round((np.arange(C * f) + 0.5) / f - 0.5)
                             .astype(int), 0, C - 1)
                ov = ov[np.ix_(rn, cn)]
            cell_size = cell_size / f
    R, C = dem.shape

    colors = _shaded_colors(dem, cell_size, dem_scale, nodata)
    if ov is not None:
        ov_rgba = render_rgba(ov, overlay_scale, nodata=nodata)
        a = (ov_rgba[..., 3:4].astype(np.float64) / 255.0) * overlay_alpha
        mix = ov_rgba[..., :3] * a + colors[..., :3] * (1 - a)
        colors[..., :3] = np.round(mix).astype(np.uint8)

    # world coordinates, centered (geometry.cpp m_xCenter/m_yCenter/m_zCenter)
    rows, cols = np.nonzero(valid)
    z = dem[rows, cols]
    x = (cols + 0.5) * cell_size
    y = (R - rows - 0.5) * cell_size
    x -= (C * cell_size) / 2.0
    y -= (R * cell_size) / 2.0
    zc = (float(z.min()) + float(z.max())) / 2.0
    extent = max(C, R) * cell_size
    if magnify is None:
        zr = max(float(z.max()) - float(z.min()), 1e-9)
        magnify = 0.15 * extent / zr
    zz = (z - zc) * magnify

    # rotate about vertical axis, then tilt about the screen-x axis
    a = np.radians(rotation_deg)
    xr = x * np.cos(a) - y * np.sin(a)
    yr = x * np.sin(a) + y * np.cos(a)
    t = np.radians(tilt_deg)
    ys = yr * np.cos(t) - zz * np.sin(t)      # screen-up component
    depth = yr * np.sin(t) + zz * np.cos(t)   # toward the camera

    # orthographic fit to the canvas
    sx, sy = xr, -ys
    x0, x1 = float(sx.min()), float(sx.max())
    y0, y1 = float(sy.min()), float(sy.max())
    s = min((width - 2 * pad) / max(x1 - x0, 1e-9),
            (height - 2 * pad) / max(y1 - y0, 1e-9))
    px = np.round((sx - x0) * s + (width - (x1 - x0) * s) / 2).astype(np.int64)
    py = np.round((sy - y0) * s + (height - (y1 - y0) * s) / 2).astype(np.int64)

    # splat footprint: cover one projected cell (+1 px to close seams)
    k = int(np.ceil(cell_size * s)) + 1
    k = max(min(k, 12), 1)

    cv = Canvas(width, height, background=(255, 255, 255, 255))
    zbuf = np.full(width * height, -np.inf)
    col_pts = colors[rows, cols]
    offs = [(di, dj) for di in range(-(k // 2), k - k // 2)
            for dj in range(-(k // 2), k - k // 2)]
    flats = []
    for di, dj in offs:
        yy = np.clip(py + di, 0, height - 1)
        xx = np.clip(px + dj, 0, width - 1)
        flat = yy * width + xx
        np.maximum.at(zbuf, flat, depth)
        flats.append(flat)
    img = cv.rgba.reshape(-1, 4)
    for flat in flats:
        sel = depth >= zbuf[flat]
        img[flat[sel]] = col_pts[sel]

    if title:
        cv.text(width // 2, 6, title, scale=2 if width > 500 else 1,
                anchor="n")
    cv.text(width - 8, height - 10,
            f"Z x{magnify:.3g}  ROT {rotation_deg:.0f}°  TILT {tilt_deg:.0f}°",
            anchor="se", color=(90, 90, 90))
    return cv

"""Coordinate reprojection for rasters and shapefile geometries.

The port's own copy of ``criteria3d_tpu/io/reproject.py``, line for line (host
numpy and the standard library). The ellipsoid math is the
port's ``core/geo.py``.

The analogue of the reference's GDAL-backed reprojection
(agrolib/gdalHandler/gdalRasterFunctions.cpp gdalReprojection,
gdalShapeFunctions.cpp gdalShapeToRaster's on-the-fly warp): the CRS pairs
the framework itself works in — UTM/WGS84 zones and geographic lat-lon —
are transformed with the same ellipsoid math as the rest of the package
(core/geo.py, the gis.cpp:870-1003 port), with no external GDAL
dependency. Raster warping is inverse-mapping (every target cell centre is
transformed back into the source grid and sampled nearest/bilinear — the
standard GDALWarp kernel for these methods).

CRS spec: ``("latlon",)`` or ``("utm", zone_number)`` with an optional
third element giving the hemisphere reference latitude (default 45.0,
i.e. northern).
"""

from __future__ import annotations

import numpy as np

from criteria3d_tpu_torch.constants import NODATA
from criteria3d_tpu_torch.core.geo import latlon_to_utm, utm_to_latlon
from criteria3d_tpu_torch.io.esri import RasterHeader

__all__ = ["transform_points", "reproject_shape", "reproject_shapes",
           "reproject_raster"]


def _check_crs(crs) -> tuple:
    if not crs or crs[0] not in ("latlon", "utm"):
        raise ValueError(f"unsupported CRS spec: {crs!r} "
                         "(use ('latlon',) or ('utm', zone[, ref_lat]))")
    if crs[0] == "utm" and len(crs) < 2:
        raise ValueError("UTM CRS needs a zone number: ('utm', zone)")
    return crs


def transform_points(x, y, src, dst):
    """Transform coordinate arrays between CRSs; returns (x', y')."""
    src, dst = _check_crs(src), _check_crs(dst)
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    def _normalized(crs):
        # identity requires matching hemisphere ref-lat too (defaulted 45.0)
        if crs[0] == "utm":
            return ("utm", crs[1], crs[2] if len(crs) > 2 else 45.0)
        return ("latlon",)

    if _normalized(src) == _normalized(dst):
        return x, y

    # to geographic
    if src[0] == "utm":
        ref_lat = src[2] if len(src) > 2 else 45.0
        lat, lon = utm_to_latlon(src[1], ref_lat, x, y)
    else:
        lat, lon = y, x

    if dst[0] == "latlon":
        return lon, lat
    e, n, _ = latlon_to_utm(lat, lon, dst[1])
    # latlon_to_utm applies the 10 Mm false northing whenever lat < 0, the
    # south-referenced encoding. A north-referenced destination CRS
    # (ref_lat >= 0) must instead carry southern points as negative
    # northings so utm_to_latlon(ref_lat>=0) round-trips them.
    dst_ref = dst[2] if len(dst) > 2 else 45.0
    if dst_ref >= 0:
        n = np.where(np.asarray(lat) < 0, np.asarray(n) - 10000000.0, n)
    return np.asarray(e), np.asarray(n)


def reproject_shape(shape, src, dst):
    """A new ShapeObject with every vertex transformed."""
    from criteria3d_tpu_torch.io.shapefile import ShapeObject

    parts = []
    for ring in shape.parts:
        x, y = transform_points(ring[:, 0], ring[:, 1], src, dst)
        parts.append(np.column_stack([x, y]))
    return ShapeObject(shape.shape_type, parts)


def reproject_shapes(shapes: list, src, dst) -> list:
    """Transform a whole shapefile's geometry list (records unchanged)."""
    return [reproject_shape(s, src, dst) for s in shapes]


def reproject_raster(values: np.ndarray, header: RasterHeader, src, dst,
                     out_header: RasterHeader | None = None,
                     out_cellsize: float | None = None,
                     method: str = "nearest"
                     ) -> tuple[np.ndarray, RasterHeader]:
    """Warp a raster between CRSs.

    Without ``out_header`` the target grid is derived from the transformed
    source corners at ``out_cellsize`` (default: matches the source pixel
    count along the larger axis). ``method``: nearest | bilinear.
    Returns (values', header'); cells mapping outside the source (or onto
    nodata) become the source nodata value.
    """
    src, dst = _check_crs(src), _check_crs(dst)
    values = np.asarray(values, np.float64)
    R, C = values.shape
    cs = header.cellsize

    if out_header is None:
        # transform the outline (all four edges, not only corners — the
        # transform is curvilinear) to get the target bounding box
        edge = np.linspace(0.0, 1.0, 65)
        xs = header.xllcorner + edge * C * cs
        ys = header.yllcorner + edge * R * cs
        bx = np.concatenate([xs, xs, np.full_like(ys, xs[0]),
                             np.full_like(ys, xs[-1])])
        by = np.concatenate([np.full_like(xs, ys[0]),
                             np.full_like(xs, ys[-1]), ys, ys])
        tx, ty = transform_points(bx, by, src, dst)
        if out_cellsize is None:
            out_cellsize = max((tx.max() - tx.min()) / C,
                               (ty.max() - ty.min()) / R)
        nc = int(np.ceil((tx.max() - tx.min()) / out_cellsize))
        nr = int(np.ceil((ty.max() - ty.min()) / out_cellsize))
        out_header = RasterHeader(nrows=nr, ncols=nc,
                                  xllcorner=float(tx.min()),
                                  yllcorner=float(ty.min()),
                                  cellsize=float(out_cellsize),
                                  nodata=header.nodata)

    # inverse mapping: target centres -> source CRS
    oc = out_header.cellsize
    gx = out_header.xllcorner + (np.arange(out_header.ncols) + 0.5) * oc
    gy = out_header.yllcorner + (out_header.nrows - 0.5
                                 - np.arange(out_header.nrows)) * oc
    xx, yy = np.meshgrid(gx, gy)
    sx, sy = transform_points(xx, yy, dst, src)

    # fractional source indices (row 0 = north)
    fc = (sx - header.xllcorner) / cs - 0.5
    fr = (header.yllcorner + R * cs - sy) / cs - 0.5
    nodata = header.nodata
    valid_src = ~np.isclose(values, nodata)

    if method == "nearest":
        ri = np.rint(fr).astype(int)
        ci = np.rint(fc).astype(int)
        inside = (ri >= 0) & (ri < R) & (ci >= 0) & (ci < C)
        out = np.full(xx.shape, nodata)
        out[inside] = values[ri[inside], ci[inside]]
    elif method == "bilinear":
        r0 = np.clip(np.floor(fr).astype(int), 0, R - 1)
        c0 = np.clip(np.floor(fc).astype(int), 0, C - 1)
        r1 = np.clip(r0 + 1, 0, R - 1)
        c1 = np.clip(c0 + 1, 0, C - 1)
        wr = np.clip(fr - r0, 0.0, 1.0)
        wc = np.clip(fc - c0, 0.0, 1.0)
        inside = (fr >= -0.5) & (fr <= R - 0.5) & (fc >= -0.5) & (fc <= C - 0.5)
        corners = [values[r0, c0], values[r0, c1], values[r1, c0],
                   values[r1, c1]]
        weights = [(1 - wr) * (1 - wc), (1 - wr) * wc, wr * (1 - wc),
                   wr * wc]
        ok = valid_src[r0, c0] & valid_src[r0, c1] & valid_src[r1, c0] \
            & valid_src[r1, c1]
        interp = sum(c * w for c, w in zip(corners, weights))
        out = np.where(inside & ok, interp, nodata)
        # fall back to nearest where only some corners are valid
        near = values[np.clip(np.rint(fr).astype(int), 0, R - 1),
                      np.clip(np.rint(fc).astype(int), 0, C - 1)]
        partial = inside & ~ok & valid_src[
            np.clip(np.rint(fr).astype(int), 0, R - 1),
            np.clip(np.rint(fc).astype(int), 0, C - 1)]
        out = np.where(partial, near, out)
    else:
        raise ValueError(f"unknown method: {method}")

    return out, out_header

"""Shape ↔ raster utilities: rasterization, zonal statistics, CSV join.

The port's own copy of ``criteria3d_tpu/io/shape_utils.py``, line for line (host
numpy and the standard library).

Re-implements the reference's agrolib/shapeUtilities capabilities
(shapeToRaster.{h,cpp}, zonalStatistic.{h,cpp}, shapeFromCsv.{h,cpp},
shapeUtilities.{h,cpp}) with vectorized numpy:

* ``initialize_raster_from_shape`` / ``fill_raster_with_shape_index`` /
  ``rasterize_shape`` — polygon rasterization onto a Crit3D-style raster
  (even-odd rule over cell centres, vectorized per ring).
* ``compute_matrix_analysis_raster`` + ``zonal_statistics_vector`` /
  ``zonal_statistics_shape`` / majority variants — zone × category
  cross-tabs and AVG/MIN/MAX/MEDIAN/STDEV/MAJORITY aggregation written
  back to shape attributes.
* ``shape_from_csv`` — join CSV columns onto shape records by a key field.
* ``clone_shape_file`` / ``copy_shape_file`` — file-level helpers.
"""

from __future__ import annotations

import csv as _csv
import os
import shutil

import numpy as np

from criteria3d_tpu_torch.io.esri import RasterHeader
from criteria3d_tpu_torch.io.shapefile import POLYGON, ShapeHandler, ShapeObject

__all__ = [
    "initialize_raster_from_shape", "fill_raster_with_shape_index",
    "rasterize_shape", "rasterize_shape_object",
    "compute_matrix_analysis_raster", "zonal_statistics_vector",
    "zonal_statistics_shape", "zonal_statistics_shape_majority",
    "shape_from_csv", "clone_shape_file", "copy_shape_file",
]


def initialize_raster_from_shape(handler: ShapeHandler, cellsize: float,
                                 nodata: float = -9999.0
                                 ) -> tuple[np.ndarray, RasterHeader]:
    """Empty raster covering the shapefile bounds
    (shapeToRaster.cpp initializeRasterFromShape)."""
    xmin, xmax, ymin, ymax = handler.get_bounds()
    ncols = max(1, int(np.ceil((xmax - xmin) / cellsize)))
    nrows = max(1, int(np.ceil((ymax - ymin) / cellsize)))
    header = RasterHeader(nrows=nrows, ncols=ncols, xllcorner=float(xmin),
                          yllcorner=float(ymin), cellsize=float(cellsize),
                          nodata=nodata)
    return np.full((nrows, ncols), nodata), header


def _cell_centers(header: RasterHeader):
    cols = np.arange(header.ncols)
    rows = np.arange(header.nrows)
    xs = header.xllcorner + (cols + 0.5) * header.cellsize
    ys = header.yllcorner + (header.nrows - rows - 0.5) * header.cellsize
    return xs, ys      # xs indexed by col, ys by row (row 0 = north)


def rasterize_shape_object(shape: ShapeObject, header: RasterHeader,
                           out: np.ndarray, value: float) -> None:
    """Burn `value` into `out` where cell centres fall inside the polygon
    (even-odd over all rings, so holes are excluded). Vectorized: one
    crossing-number test per ring over the bbox cell block."""
    if shape.shape_type != POLYGON or not shape.parts:
        return
    xs, ys = _cell_centers(header)
    x0, y0, x1, y1 = shape.bounds
    csel = np.nonzero((xs >= x0 - header.cellsize) & (xs <= x1 + header.cellsize))[0]
    rsel = np.nonzero((ys >= y0 - header.cellsize) & (ys <= y1 + header.cellsize))[0]
    if csel.size == 0 or rsel.size == 0:
        return
    X = xs[csel][None, :]                    # [1, C]
    Y = ys[rsel][:, None]                    # [R, 1]
    inside = np.zeros((rsel.size, csel.size), dtype=bool)
    for ring in shape.parts:
        rx, ry = ring[:, 0], ring[:, 1]
        rx2, ry2 = np.roll(rx, -1), np.roll(ry, -1)
        # edges [E]; broadcast against cells [R, C, E] in row chunks
        for i0 in range(0, rsel.size, 256):
            Yb = Y[i0:i0 + 256]
            crosses = (ry[None, None, :] > Yb[..., None]) != \
                      (ry2[None, None, :] > Yb[..., None])
            with np.errstate(divide="ignore", invalid="ignore"):
                t = (Yb[..., None] - ry[None, None, :]) / \
                    (ry2 - ry)[None, None, :]
                xint = rx[None, None, :] + t * (rx2 - rx)[None, None, :]
            hits = crosses & (X[..., None] < xint)
            inside[i0:i0 + 256] ^= (np.count_nonzero(hits, axis=-1) % 2) == 1
    out[np.ix_(rsel, csel)] = np.where(inside, value, out[np.ix_(rsel, csel)])


def fill_raster_with_shape_index(raster: np.ndarray, header: RasterHeader,
                                 handler: ShapeHandler) -> np.ndarray:
    """Burn each (non-deleted) shape's index
    (shapeToRaster.cpp fillRasterWithShapeIndex)."""
    for i, shape in enumerate(handler.shapes):
        if not handler.deleted[i]:
            rasterize_shape_object(shape, header, raster, float(i))
    return raster


def rasterize_shape(handler: ShapeHandler, field_name: str,
                    header: RasterHeader | None = None,
                    cellsize: float | None = None,
                    nodata: float = -9999.0
                    ) -> tuple[np.ndarray, RasterHeader]:
    """Rasterize a numeric attribute (shapeToRaster.cpp rasterizeShape)."""
    if header is None:
        if cellsize is None:
            raise ValueError("need header or cellsize")
        out, header = initialize_raster_from_shape(handler, cellsize, nodata)
    else:
        out = np.full((header.nrows, header.ncols), nodata)
    for i, shape in enumerate(handler.shapes):
        if handler.deleted[i]:
            continue
        v = handler.get_numeric_value(i, field_name)
        if np.isfinite(v):
            rasterize_shape_object(shape, header, out, v)
    return out, header


# ------------------------------------------------------- zonal statistics --

def compute_matrix_analysis_raster(zone_raster: np.ndarray,
                                   value_raster: np.ndarray,
                                   categories: np.ndarray,
                                   nodata: float = -9999.0
                                   ) -> tuple[np.ndarray, np.ndarray]:
    """Cross-tab: count of cells per (zone, category) plus per-zone count of
    cells whose value matches no category
    (zonalStatistic.cpp computeMatrixAnalysisRaster). zone_raster holds
    shape indices (from fill_raster_with_shape_index)."""
    zones = np.where(np.isclose(zone_raster, nodata), -1,
                     zone_raster).astype(np.int64)
    n_zones = int(zones.max()) + 1 if (zones >= 0).any() else 0
    categories = np.asarray(categories)
    matrix = np.zeros((n_zones, len(categories)), dtype=np.int64)
    null_count = np.zeros(n_zones, dtype=np.int64)
    valid = zones >= 0
    vals = value_raster[valid]
    zs = zones[valid]
    matched = np.zeros(vals.shape, dtype=bool)
    for j, cat in enumerate(categories):
        hit = np.isclose(vals, cat)
        np.add.at(matrix[:, j], zs[hit], 1)
        matched |= hit
    value_null = np.isclose(vals, nodata) | ~matched
    np.add.at(null_count, zs[value_null], 1)
    return matrix, null_count


def zonal_statistics_vector(zone_raster: np.ndarray,
                            value_raster: np.ndarray,
                            n_zones: int,
                            aggregation: str = "AVG",
                            threshold: float = 0.5,
                            nodata: float = -9999.0) -> np.ndarray:
    """Aggregate `value_raster` per zone (zonalStatistic.cpp
    zonalStatisticsShape semantics): AVG, MIN, MAX, MEDIAN, STDEV or
    MAJORITY. Zones whose null-cell fraction exceeds `threshold` get
    nodata."""
    zones = np.where(np.isclose(zone_raster, nodata), -1,
                     zone_raster).astype(np.int64)
    valid_zone = zones >= 0
    value_ok = valid_zone & ~np.isclose(value_raster, nodata) & \
        np.isfinite(value_raster)
    out = np.full(n_zones, nodata)
    total = np.bincount(zones[valid_zone], minlength=n_zones)
    good = np.bincount(zones[value_ok], minlength=n_zones)
    frac_null = np.where(total > 0, 1.0 - good / np.maximum(total, 1), 1.0)
    agg = aggregation.upper()
    zs, vs = zones[value_ok], value_raster[value_ok]
    for z in range(n_zones):
        if total[z] == 0 or frac_null[z] > threshold:
            continue
        v = vs[zs == z]
        if v.size == 0:
            continue
        if agg == "AVG":
            out[z] = v.mean()
        elif agg == "MIN":
            out[z] = v.min()
        elif agg == "MAX":
            out[z] = v.max()
        elif agg == "MEDIAN":
            out[z] = np.median(v)
        elif agg in ("STDEV", "STD"):
            out[z] = v.std(ddof=0)
        elif agg == "MAJORITY":
            vals, counts = np.unique(v, return_counts=True)
            out[z] = vals[np.argmax(counts)]
        else:
            raise ValueError(f"unknown aggregation {aggregation}")
    return out


def zonal_statistics_shape(handler: ShapeHandler, zone_raster: np.ndarray,
                           value_raster: np.ndarray, field_output: str,
                           aggregation: str = "AVG", threshold: float = 0.5,
                           nodata: float = -9999.0,
                           decimals: int = 2) -> np.ndarray:
    """Aggregate a value raster over each shape's zone and write the result
    to a (new) attribute field."""
    stats = zonal_statistics_vector(zone_raster, value_raster,
                                    handler.shape_count, aggregation,
                                    threshold, nodata)
    handler.add_field(field_output, "N", 16, decimals)
    for i, v in enumerate(stats):
        handler.write_attribute(i, field_output,
                                None if np.isclose(v, nodata) else float(v))
    return stats


def zonal_statistics_shape_majority(handler: ShapeHandler,
                                    zone_raster: np.ndarray,
                                    value_raster: np.ndarray,
                                    field_output: str,
                                    threshold: float = 0.5,
                                    nodata: float = -9999.0) -> np.ndarray:
    return zonal_statistics_shape(handler, zone_raster, value_raster,
                                  field_output, "MAJORITY", threshold,
                                  nodata, decimals=0)


# --------------------------------------------------------------- helpers --

def shape_from_csv(handler: ShapeHandler, csv_path: str, key_field: str,
                   csv_key: str | None = None) -> int:
    """Join CSV columns onto shape records matching key_field
    (shapeFromCsv.cpp semantics: new numeric/string fields from the CSV
    header; returns number of matched records)."""
    csv_key = csv_key or key_field
    with open(csv_path, newline="") as f:
        reader = _csv.DictReader(f)
        rows = {str(r[csv_key]).strip(): r for r in reader}
        columns = [c for c in (reader.fieldnames or []) if c != csv_key]
    for col in columns:
        numeric = all(_is_number(r.get(col, "")) for r in rows.values())
        handler.add_field(col[:11], "N" if numeric else "C",
                          18 if numeric else 32, 6 if numeric else 0)
    matched = 0
    for i in range(handler.shape_count):
        key = handler.get_string_value(i, key_field).strip()
        if not key:
            v = handler.get_numeric_value(i, key_field)
            if np.isfinite(v):
                key = str(int(v)) if v == int(v) else str(v)
        row = rows.get(key)
        if row is None:
            continue
        matched += 1
        for col in columns:
            val = row.get(col, "")
            handler.write_attribute(
                i, col[:11], float(val) if _is_number(val) else val)
    return matched


def _is_number(s) -> bool:
    try:
        float(s)
        return True
    except (TypeError, ValueError):
        return False


def clone_shape_file(src: str, dst: str) -> None:
    """Copy .shp/.shx/.dbf/.prj (shapeUtilities.cpp cloneShapeFile)."""
    src_base = os.path.splitext(src)[0]
    dst_base = os.path.splitext(dst)[0]
    for ext in (".shp", ".shx", ".dbf", ".prj"):
        if os.path.exists(src_base + ext):
            shutil.copyfile(src_base + ext, dst_base + ext)


copy_shape_file = clone_shape_file

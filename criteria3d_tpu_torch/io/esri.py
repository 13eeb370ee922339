"""ESRI binary float (.flt/.hdr), ASCII grid (.asc) and ENVI (.img/.hdr) IO,
plus raster resampling/aggregation, pure numpy.

The port's own copy of ``criteria3d_tpu/io/esri.py``, line for line (a
``.tif`` path reads through the port's ``io/geotiff.py``). Re-implements
the raster IO of the reference's gis layer (agrolib/gis/gisIO.cpp:122-717:
ESRI/ENVI/ascii read-write) and
gis::resampleGrid (gis.cpp:1722-1805) in numpy: the .hdr sidecar carries
nrows/ncols/cell size/corner/nodata, the .flt is row-major float32 starting
from the **north-west** corner (row 0 = top).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

__all__ = ["RasterHeader", "read_flt", "write_flt", "read_asc", "write_asc",
           "read_envi", "write_envi", "read_raster", "resample_grid"]


@dataclasses.dataclass
class RasterHeader:
    nrows: int
    ncols: int
    xllcorner: float
    yllcorner: float
    cellsize: float
    nodata: float = -9999.0

    def xy(self, row: int, col: int) -> tuple[float, float]:
        """UTM centre coordinates of a cell (row 0 = north)."""
        x = self.xllcorner + (col + 0.5) * self.cellsize
        y = self.yllcorner + (self.nrows - row - 0.5) * self.cellsize
        return x, y


def _parse_hdr(path: str) -> tuple[RasterHeader, bool]:
    kv = {}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                kv[parts[0].lower()] = parts[1]
    hdr = RasterHeader(
        nrows=int(kv["nrows"]), ncols=int(kv["ncols"]),
        xllcorner=float(kv.get("xllcorner", 0.0)),
        yllcorner=float(kv.get("yllcorner", 0.0)),
        cellsize=float(kv["cellsize"]),
        nodata=float(kv.get("nodata_value", kv.get("nodata", -9999.0))),
    )
    little = kv.get("byteorder", "LSBFIRST").upper().startswith("LSB")
    return hdr, little


def read_flt(path: str) -> tuple[np.ndarray, RasterHeader]:
    """Read an ESRI .flt/.hdr pair. `path` may omit the extension."""
    base = path[:-4] if path.endswith((".flt", ".hdr")) else path
    hdr, little = _parse_hdr(base + ".hdr")
    dtype = "<f4" if little else ">f4"
    data = np.fromfile(base + ".flt", dtype=dtype)
    if data.size != hdr.nrows * hdr.ncols:
        raise ValueError(
            f"{base}.flt has {data.size} values, expected {hdr.nrows * hdr.ncols}")
    return data.reshape(hdr.nrows, hdr.ncols).astype(np.float64), hdr


def write_flt(path: str, data: np.ndarray, header: RasterHeader) -> None:
    base = path[:-4] if path.endswith((".flt", ".hdr")) else path
    with open(base + ".hdr", "w") as f:
        f.write(f"ncols         {header.ncols}\n"
                f"nrows         {header.nrows}\n"
                f"xllcorner     {header.xllcorner}\n"
                f"yllcorner     {header.yllcorner}\n"
                f"cellsize      {header.cellsize}\n"
                f"NODATA_value  {header.nodata}\n"
                f"byteorder     LSBFIRST\n")
    np.asarray(data, dtype="<f4").tofile(base + ".flt")


def read_asc(path: str) -> tuple[np.ndarray, RasterHeader]:
    """Read an ESRI ASCII grid (.asc)."""
    kv = {}
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0][0].isalpha():
                kv[parts[0].lower()] = parts[1]
            else:
                rows.append([float(v) for v in parts])
    hdr = RasterHeader(
        nrows=int(kv["nrows"]), ncols=int(kv["ncols"]),
        xllcorner=float(kv.get("xllcorner", 0.0)),
        yllcorner=float(kv.get("yllcorner", 0.0)),
        cellsize=float(kv["cellsize"]),
        nodata=float(kv.get("nodata_value", -9999.0)),
    )
    data = np.array(rows, dtype=np.float64).reshape(hdr.nrows, hdr.ncols)
    return data, hdr


def write_asc(path: str, data: np.ndarray, header: RasterHeader) -> None:
    with open(path, "w") as f:
        f.write(f"ncols {header.ncols}\nnrows {header.nrows}\n"
                f"xllcorner {header.xllcorner}\nyllcorner {header.yllcorner}\n"
                f"cellsize {header.cellsize}\nNODATA_value {header.nodata}\n")
        np.savetxt(f, np.asarray(data), fmt="%.6g")


# ----------------------------------------------------------------------
# ENVI raster (.img + ENVI .hdr) — readEnviGrid/writeEnviGrid
# (gisIO.cpp:202-340, 568-700, 741-800)
# ----------------------------------------------------------------------

_ENVI_DTYPES = {1: "u1", 2: "<i2", 3: "<i4", 4: "<f4", 5: "<f8",
                12: "<u2", 13: "<u4"}


def _parse_envi_hdr(path: str) -> tuple[RasterHeader, dict]:
    kv = {}
    with open(path) as f:
        text = f.read()
    for line in text.splitlines():
        if "=" not in line:
            continue
        key, _, val = line.partition("=")
        kv[key.strip().lower()] = val.strip()
    samples = int(kv["samples"])
    lines = int(kv["lines"])
    # map info = {UTM, 1, 1, ulx, uly, xsize, ysize, zone, North, datum, ...}
    cellsize, xll, yll = 1.0, 0.0, 0.0
    if "map info" in kv:
        parts = [p.strip() for p in kv["map info"].strip("{}").split(",")]
        if len(parts) >= 7:
            ulx, uly = float(parts[3]), float(parts[4])
            cellsize = float(parts[5])
            xll = ulx
            yll = uly - lines * cellsize
    hdr = RasterHeader(
        nrows=lines, ncols=samples, xllcorner=xll, yllcorner=yll,
        cellsize=cellsize,
        nodata=float(kv.get("data ignore value", -9999.0)))
    return hdr, kv


def read_envi(path: str) -> tuple[np.ndarray, RasterHeader]:
    """Read an ENVI .img/.hdr raster (readEnviGrid, gisIO.cpp:568-700).
    `path` may omit the extension."""
    base = path[:-4] if path.endswith((".img", ".hdr")) else path
    hdr, kv = _parse_envi_hdr(base + ".hdr")
    dtype = _ENVI_DTYPES.get(int(kv.get("data type", 4)), "<f4")
    if int(kv.get("byte order", 0)) == 1 and dtype[0] == "<":
        dtype = ">" + dtype[1:]
    offset = int(kv.get("header offset", 0))
    data = np.fromfile(base + ".img", dtype=dtype, offset=offset)
    n = hdr.nrows * hdr.ncols
    if data.size < n:
        raise ValueError(f"{base}.img has {data.size} values, expected {n}")
    return data[:n].reshape(hdr.nrows, hdr.ncols).astype(np.float64), hdr


def write_envi(path: str, data: np.ndarray, header: RasterHeader,
               utm_zone: int = 32) -> None:
    """Write an ENVI float raster (writeEnviGrid, gisIO.cpp:741-800)."""
    base = path[:-4] if path.endswith((".img", ".hdr")) else path
    uly = header.yllcorner + header.nrows * header.cellsize
    with open(base + ".hdr", "w") as f:
        f.write("ENVI\n"
                "description = {raster grid}\n"
                f"samples = {header.ncols}\n"
                f"lines = {header.nrows}\n"
                "bands = 1\n"
                "header offset = 0\n"
                "file type = ENVI Standard\n"
                "data type = 4\n"
                "interleave = bsq\n"
                "byte order = 0\n"
                f"data ignore value = {header.nodata}\n"
                f"map info = {{UTM, 1, 1, {header.xllcorner:.6f}, "
                f"{uly:.6f}, {header.cellsize:g}, {header.cellsize:g}, "
                f"{utm_zone}, North, WGS-84, units=Meters}}\n")
    np.asarray(data, dtype="<f4").tofile(base + ".img")


def read_raster(path: str) -> tuple[np.ndarray, RasterHeader]:
    """Open a raster by extension: .flt (ESRI float), .img (ENVI), .asc
    (ascii grid). Extensionless paths try .flt then .img (openRaster,
    gisIO.cpp:703-739)."""
    if path.endswith(".asc"):
        return read_asc(path)
    if path.endswith(".img"):
        return read_envi(path)
    if path.endswith((".flt", ".hdr")):
        return read_flt(path)
    if path.endswith((".tif", ".tiff")):
        from criteria3d_tpu_torch.io.geotiff import read_geotiff
        return read_geotiff(path)
    if os.path.exists(path + ".flt"):
        return read_flt(path)
    if os.path.exists(path + ".img"):
        return read_envi(path)
    if os.path.exists(path + ".asc"):
        return read_asc(path)
    if os.path.exists(path + ".tif"):
        from criteria3d_tpu_torch.io.geotiff import read_geotiff
        return read_geotiff(path + ".tif")
    raise FileNotFoundError(path)


# ----------------------------------------------------------------------
# resampling / aggregation — gis::resampleGrid (gis.cpp:1722-1805)
# ----------------------------------------------------------------------

def resample_grid(values: np.ndarray, header: RasterHeader,
                  new_header: RasterHeader, method: str = "prevailing",
                  nodata_ratio_threshold: float = 0.0) -> np.ndarray:
    """Resample a raster onto a new header grid.

    Mirrors gis::resampleGrid (gis.cpp:1722-1805): when the new cell is not
    larger than the old one (or ``method='center'``) each new cell takes the
    value at its centre; otherwise ``floor(factor)+1`` sub-samples per axis
    are aggregated by ``'average'`` / ``'median'`` / ``'prevailing'``
    (majority — the land-use/soil-map default, project3D.cpp:673,699),
    subject to a valid-sample ratio threshold.
    """
    values = np.asarray(values, dtype=np.float64)
    R2, C2 = new_header.nrows, new_header.ncols
    factor = new_header.cellsize / header.cellsize

    def lookup(x, y):
        """values at UTM coordinate arrays, NODATA outside."""
        col = np.floor((x - header.xllcorner) / header.cellsize).astype(int)
        row = header.nrows - 1 - np.floor(
            (y - header.yllcorner) / header.cellsize).astype(int)
        inside = (row >= 0) & (row < header.nrows) & \
                 (col >= 0) & (col < header.ncols)
        out = np.full(x.shape, header.nodata)
        out[inside] = values[row[inside], col[inside]]
        return out

    rows2, cols2 = np.mgrid[0:R2, 0:C2]
    xc = new_header.xllcorner + (cols2 + 0.5) * new_header.cellsize
    yc = new_header.yllcorner + (R2 - rows2 - 0.5) * new_header.cellsize

    if factor <= 1.0 or method == "center":
        out = lookup(xc, yc)
        return np.where(np.isclose(out, header.nodata), new_header.nodata, out)

    n_step = int(np.floor(factor)) + 1
    step = new_header.cellsize / n_step
    # sub-sample offsets relative to the cell centre
    offs = (np.arange(n_step) + 0.5) * step - new_header.cellsize / 2.0
    sample = np.empty((R2, C2, n_step * n_step))
    k = 0
    for dx in offs:
        for dy in offs:
            sample[:, :, k] = lookup(xc + dx, yc + dy)
            k += 1
    valid = ~np.isclose(sample, header.nodata)
    n_valid = valid.sum(axis=2)
    n_total = n_step * n_step
    enough = (n_valid / n_total) > nodata_ratio_threshold
    enough &= n_valid > 0

    if method == "average":
        s = np.where(valid, sample, 0.0).sum(axis=2)
        out = s / np.maximum(n_valid, 1)
    elif method == "median":
        tmp = np.where(valid, sample, np.nan)
        with np.errstate(all="ignore"):
            out = np.nanmedian(tmp, axis=2)
        out = np.nan_to_num(out, nan=new_header.nodata)
    elif method == "prevailing":
        # majority vote over the (small) set of codes present
        codes = np.unique(sample[valid]) if valid.any() else np.array([])
        if codes.size == 0:
            return np.full((R2, C2), new_header.nodata)
        counts = np.stack([(valid & np.isclose(sample, c)).sum(axis=2)
                           for c in codes], axis=0)
        out = codes[np.argmax(counts, axis=0)]
        # prevailing also requires more valid than missing samples
        enough &= n_valid > (n_total - n_valid)
    else:
        raise ValueError(f"unknown resampling method: {method}")

    return np.where(enough, out, new_header.nodata)

"""ESRI binary float rasters (.flt/.hdr), pure numpy.

The port's own copy of the .flt reader and writer of
``criteria3d_tpu/io/esri.py`` (the reference's agrolib/gis/gisIO.cpp): the
.hdr sidecar carries nrows/ncols/cell size/corner/nodata, the .flt is
row-major float32 starting from the **north-west** corner (row 0 = top).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["RasterHeader", "read_flt", "write_flt"]


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
    """Read an ESRI .flt/.hdr pair as float64. `path` may omit the
    extension."""
    base = path[:-4] if path.endswith((".flt", ".hdr")) else path
    hdr, little = _parse_hdr(base + ".hdr")
    dtype = "<f4" if little else ">f4"
    data = np.fromfile(base + ".flt", dtype=dtype)
    if data.size != hdr.nrows * hdr.ncols:
        raise ValueError(
            f"{base}.flt has {data.size} values, expected {hdr.nrows * hdr.ncols}")
    return data.reshape(hdr.nrows, hdr.ncols).astype(np.float64), hdr


def write_flt(path: str, data: np.ndarray, header: RasterHeader) -> None:
    """Write ``data`` as a little-endian float32 .flt with its .hdr."""
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

"""NetCDF raster read/export (reference: agrolib/netcdfHandler/netcdfHandler.{h,cpp}).

NetCDF-3 classic files via scipy.io.netcdf_file, NetCDF-4 (HDF5-backed,
the format most real-world gridded inputs use today — the reference links
libnetcdf, netcdfHandler.h:25) via h5py with the netCDF-4 dimension-scale
conventions. Covers the reference handler's model-facing capabilities:

* ``NetCDFHandler.read(path)`` — detect UTM (x/y) vs lat-lon grids, time
  axis (hours/days since epoch), variable inventory with long_name/units,
  missing value; extract a (time, var) slice as a raster + header.
* ``export_raster`` — write a single raster (UTM or lat-lon) to NetCDF
  (netcdfHandler.cpp writeGeoAndDateDimensions / exportDataSeries
  analogues).
* ``export_series`` — write a time series of rasters with a CF-style
  "hours since" time axis.

Rotated-pole grids are detected and reported but not reprojected (the
reference likewise only reads them as-is).

The port's own copy of ``criteria3d_tpu/io/netcdf.py``, line for line,
except that ``scipy.io.netcdf_file`` is imported inside the functions that
open a file (the port imports torch and numpy only at module level);
h5py, as in JAX, only when a NetCDF-4 file is read.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import re

import numpy as np

from criteria3d_tpu_torch.io.esri import RasterHeader

__all__ = ["NetCDFVariable", "NetCDFHandler", "export_raster",
           "export_series"]

_EPOCH_RE = re.compile(
    r"(seconds|hours|days)\s+since\s+(\d{4})-(\d{1,2})-(\d{1,2})"
    r"(?:[T ](\d{1,2}):(\d{1,2})(?::(\d{1,2}))?)?")


@dataclasses.dataclass
class NetCDFVariable:
    name: str
    long_name: str = ""
    unit: str = ""
    dims: tuple = ()


def _decode(value) -> str:
    if isinstance(value, bytes):
        return value.decode("utf-8", "replace")
    if isinstance(value, np.ndarray) and value.dtype.kind in "SU":
        return _decode(value.ravel()[0])
    return str(value)


_HDF5_MAGIC = b"\x89HDF\r\n\x1a\n"


class _H5Var:
    """Adapter giving an h5py Dataset the scipy netcdf_file variable
    surface used by NetCDFHandler (slicing, .dimensions, attrs)."""

    def __init__(self, ds):
        self._ds = ds

    def __getitem__(self, key):
        return self._ds[key]

    @property
    def dimensions(self) -> tuple:
        names = []
        for dim in self._ds.dims:
            label = dim.label
            if not label and len(dim) > 0:
                label = dim[0].name.split("/")[-1]
            names.append(label)
        return tuple(names)

    def __getattr__(self, name):
        # attribute access mirrors scipy's netcdf variables (long_name,
        # units, missing_value, _FillValue)
        try:
            return self._ds.attrs[name]
        except KeyError:
            raise AttributeError(name)


class _H5File:
    """NetCDF-4 (HDF5) file presented through the scipy netcdf_file
    surface NetCDFHandler.read consumes. Dimension scales (the netCDF-4
    convention: datasets with CLASS=DIMENSION_SCALE) become
    ``dimensions``; every dataset in the root group becomes a variable
    (netCDF-4 classic model keeps all variables in the root group)."""

    def __init__(self, path: str):
        try:
            import h5py
        except ImportError as e:      # pragma: no cover - env guard
            raise ImportError(
                "reading NetCDF-4/HDF5 files requires h5py") from e
        self._f = h5py.File(path, "r")
        self.variables: dict = {}
        self.dimensions: dict = {}
        for name, obj in self._f.items():
            if not isinstance(obj, h5py.Dataset):
                continue
            self.variables[name] = _H5Var(obj)
            if obj.attrs.get("CLASS", b"") == b"DIMENSION_SCALE":
                self.dimensions[name] = obj.shape[0] if obj.ndim else 0

    def close(self) -> None:
        self._f.close()


class NetCDFHandler:
    """Reader for NetCDF-3 raster datasets."""

    def __init__(self):
        self.path = ""
        self.is_utm = False
        self.is_lat_lon = False
        self.is_rotated = False
        self.is_hourly = False
        self.is_daily = False
        self.missing_value = -9999.0
        self.variables: list[NetCDFVariable] = []
        self.x = self.y = self.lat = self.lon = None
        self.time = np.zeros(0)
        self.time_unit = ""
        self._epoch: _dt.datetime | None = None
        self._time_seconds = 1.0
        self._nc = None

    # -- reading ----------------------------------------------------------

    def read(self, path: str) -> "NetCDFHandler":
        self.path = path
        with open(path, "rb") as f:
            magic = f.read(8)
        if magic.startswith(_HDF5_MAGIC):
            nc = _H5File(path)          # NetCDF-4 (HDF5-backed)
        else:
            from scipy.io import netcdf_file
            nc = netcdf_file(path, "r", mmap=False)
        self._nc = nc
        dim_names = set(nc.dimensions)
        for name, var in nc.variables.items():
            lname = _decode(getattr(var, "long_name", b""))
            unit = _decode(getattr(var, "units", b""))
            if name in ("x", "X", "easting"):
                self.x = var[:].astype(np.float64)
                self.is_utm = True
            elif name in ("y", "Y", "northing"):
                self.y = var[:].astype(np.float64)
                self.is_utm = True
            elif name in ("lat", "latitude"):
                self.lat = var[:].astype(np.float64)
                self.is_lat_lon = self.lat.ndim == 1
                self.is_rotated = self.lat.ndim == 2
            elif name in ("lon", "longitude"):
                self.lon = var[:].astype(np.float64)
            elif name in ("time", "Time"):
                self.time = var[:].astype(np.float64)
                self.time_unit = unit
                self._parse_time_unit(unit)
            elif name not in dim_names:
                self.variables.append(
                    NetCDFVariable(name, lname, unit, var.dimensions))
                mv = getattr(var, "missing_value",
                             getattr(var, "_FillValue", None))
                if mv is not None:
                    self.missing_value = float(np.asarray(mv).ravel()[0])
        return self

    def _parse_time_unit(self, unit: str) -> None:
        m = _EPOCH_RE.search(unit)
        if not m:
            return
        step = m.group(1)
        self._time_seconds = {"seconds": 1.0, "hours": 3600.0,
                              "days": 86400.0}[step]
        self.is_hourly = step == "hours"
        self.is_daily = step == "days"
        self._epoch = _dt.datetime(
            int(m.group(2)), int(m.group(3)), int(m.group(4)),
            int(m.group(5) or 0), int(m.group(6) or 0), int(m.group(7) or 0))

    @property
    def nr_variables(self) -> int:
        return len(self.variables)

    @property
    def nr_time(self) -> int:
        return len(self.time)

    def is_loaded(self) -> bool:
        return self.nr_variables > 0

    def is_time_readable(self) -> bool:
        return self._epoch is not None and self.nr_time > 0

    def get_time(self, index: int) -> _dt.datetime:
        if self._epoch is None:
            raise ValueError("no readable time axis")
        return self._epoch + _dt.timedelta(
            seconds=float(self.time[index]) * self._time_seconds)

    def get_datetime_str(self, index: int) -> str:
        return self.get_time(index).strftime("%Y-%m-%d %H:%M")

    def get_metadata(self) -> str:
        lines = [f"file: {self.path}"]
        if self.is_utm:
            lines.append(f"grid: UTM  x={len(self.x)} y={len(self.y)}")
        if self.is_lat_lon:
            lines.append(f"grid: latlon  lon={len(self.lon)} lat={len(self.lat)}")
        if self.is_rotated:
            lines.append("grid: rotated lat-lon")
        if self.nr_time:
            lines.append(f"time: {self.nr_time} steps [{self.time_unit}]")
        for v in self.variables:
            lines.append(f"var: {v.name} ({v.long_name}) [{v.unit}]")
        return "\n".join(lines)

    def extract_raster(self, var_name: str, time_index: int = 0
                       ) -> tuple[np.ndarray, RasterHeader]:
        """Extract one 2-D slice as (grid, header); row 0 = north."""
        var = self._nc.variables[var_name]
        data = var[:]
        if data.ndim == 3:
            data = data[time_index]
        data = np.asarray(data, np.float64)
        if self.is_utm:
            axis0 = self.y
            xll, cell = float(self.x.min()), float(np.diff(self.x).mean())
            yll = float(axis0.min()) - 0.0
        else:
            axis0 = self.lat
            xll = float(self.lon.min())
            cell = float(np.abs(np.diff(self.lon)).mean())
            yll = float(axis0.min())
        if axis0 is not None and len(axis0) > 1 and axis0[1] > axis0[0]:
            data = data[::-1]           # south-up file -> row 0 = north
        nrows, ncols = data.shape
        header = RasterHeader(nrows=nrows, ncols=ncols,
                              xllcorner=xll - cell / 2.0,
                              yllcorner=yll - cell / 2.0,
                              cellsize=cell, nodata=self.missing_value)
        return data, header

    def close(self) -> None:
        if self._nc is not None:
            self._nc.close()
            self._nc = None


# -- export ----------------------------------------------------------------


def _coord_axes(header: RasterHeader, is_utm: bool):
    xs = header.xllcorner + (np.arange(header.ncols) + 0.5) * header.cellsize
    ys = header.yllcorner + (np.arange(header.nrows) + 0.5) * header.cellsize
    return xs, ys       # ys ascending (south-up, CF convention)


def export_raster(path: str, grid: np.ndarray, header: RasterHeader,
                  var_name: str = "value", unit: str = "",
                  long_name: str = "", is_utm: bool = True) -> None:
    """Write one raster to NetCDF-3 (reference exportRaster semantics)."""
    export_series(path, grid[None], header, times=None, var_name=var_name,
                  unit=unit, long_name=long_name, is_utm=is_utm)


def export_series(path: str, grids: np.ndarray, header: RasterHeader,
                  times: list[_dt.datetime] | None,
                  var_name: str = "value", unit: str = "",
                  long_name: str = "", is_utm: bool = True) -> None:
    """Write a [T, R, C] stack with an hours-since time axis."""
    grids = np.asarray(grids, np.float64)
    T, R, C = grids.shape
    from scipy.io import netcdf_file

    xs, ys = _coord_axes(header, is_utm)
    nc = netcdf_file(path, "w")
    try:
        xname, yname = ("x", "y") if is_utm else ("lon", "lat")
        nc.createDimension(xname, C)
        nc.createDimension(yname, R)
        vx = nc.createVariable(xname, "d", (xname,))
        vy = nc.createVariable(yname, "d", (yname,))
        vx[:] = xs
        vy[:] = ys
        vx.units = b"m" if is_utm else b"degrees_east"
        vy.units = b"m" if is_utm else b"degrees_north"
        dims = (yname, xname)
        if times is not None:
            nc.createDimension("time", T)
            vt = nc.createVariable("time", "d", ("time",))
            epoch = times[0].replace(minute=0, second=0, microsecond=0)
            vt[:] = [(t - epoch).total_seconds() / 3600.0 for t in times]
            vt.units = epoch.strftime("hours since %Y-%m-%d %H:%M").encode()
            dims = ("time",) + dims
        var = nc.createVariable(var_name, "f", dims)
        data = grids[:, ::-1, :]        # row 0 = north -> CF south-up
        var[:] = data if times is not None else data[0]
        if unit:
            var.units = unit.encode()
        if long_name:
            var.long_name = long_name.encode()
        var.missing_value = np.float32(header.nodata)
    finally:
        nc.close()

"""Model output variables, output points and raster export.

PyTorch counterpart of ``criteria3d_tpu/outputs.py`` (the reference's
output subsystem):

* ``criteria3DVariable`` (agrolib/meteo/meteo.h:110-114) becomes
  :class:`OutputVariable`; :func:`compute_variable_map` is the analogue of
  Project3D::computeCriteria3DMap (project3D.cpp:1896-1960) producing a 2-D
  raster of one variable at one layer, as a tensor on the grid's device;
* output points (agrolib/outputPoints): CSV point lists + per-point time
  series appended to SQLite (writeOutputPointsData,
  criteria3DProject.cpp:1274-1283); the point values of one hour come to
  the host in one copy;
* hourly output rasters at the depths configured in the project ini
  ([output] lists, Montue.ini:32-36): :func:`compute_output_rasters` stages
  the maps on the device, :func:`flush_staged_rasters` copies them to the
  host and writes them with the synchronous ESRI writer, or queues them on
  the native C++ writer pool (``native.AsyncRasterWriter``) when given one;
  the bytes are the same.
"""

from __future__ import annotations

import csv
import dataclasses
import enum
import os
import sqlite3

import numpy as np
import torch

from criteria3d_tpu_torch.constants import NODATA
from criteria3d_tpu_torch.core.grid import Grid
from criteria3d_tpu_torch.core.soil import theta_from_se
from criteria3d_tpu_torch.core.state import SolverParameters, WaterState
from criteria3d_tpu_torch.device import host_array
from criteria3d_tpu_torch.io.esri import RasterHeader, write_flt
from criteria3d_tpu_torch.ops import where

__all__ = ["OutputVariable", "compute_variable_map", "layer_index_for_depth",
           "OutputPoints", "compute_output_rasters", "flush_staged_rasters",
           "write_output_rasters", "OUTPUTS_RANGE"]

# torch.profiler range of the output maps' staging, copies and writes
# (chip_smoke.py reads it)
OUTPUTS_RANGE = "c3d.outputs"


class OutputVariable(enum.Enum):
    """criteria3DVariable (meteo.h:110-114)."""

    VOLUMETRIC_WATER_CONTENT = "waterContent"
    WATER_TOTAL_POTENTIAL = "waterTotalPotential"
    WATER_MATRIC_POTENTIAL = "waterPotential"
    DEGREE_OF_SATURATION = "degreeOfSaturation"
    SOIL_TEMPERATURE = "soilTemperature"
    SURFACE_WATER_LEVEL = "surfaceWaterLevel"
    FACTOR_OF_SAFETY = "factorOfSafety"


def layer_index_for_depth(grid: Grid, depth_cm: float) -> int:
    """Layer whose span contains the given depth (getSoilLayerIndex)."""
    depth = depth_cm / 100.0
    depths = np.asarray(grid.layer_depth)
    thicks = np.asarray(grid.layer_thickness)
    for l in range(1, grid.n_layers):
        if depths[l] - thicks[l] / 2 - 1e-9 <= depth <= depths[l] + thicks[l] / 2 + 1e-9:
            return l
    return int(np.argmin(np.abs(depths[1:] - depth)) + 1)


def compute_variable_map(grid: Grid, params: SolverParameters,
                         water: WaterState, var: OutputVariable,
                         layer: int = 0, *, heat=None, slope_deg=None
                         ) -> torch.Tensor:
    """(R, C) map of one output variable at one layer, NODATA outside, on
    the grid's device (computeCriteria3DMap, project3D.cpp:1896-1960)."""
    mask = grid.mask[layer]

    if var == OutputVariable.SURFACE_WATER_LEVEL:
        data = water.surface_water_level(grid) * 1000.0   # [mm]
        mask = grid.mask[0]
    elif var == OutputVariable.VOLUMETRIC_WATER_CONTENT:
        data = theta_from_se(grid.soil, water.se)[layer]
    elif var == OutputVariable.WATER_TOTAL_POTENTIAL:
        data = water.h[layer]
    elif var == OutputVariable.WATER_MATRIC_POTENTIAL:
        data = water.h[layer] - grid.z[layer]
    elif var == OutputVariable.DEGREE_OF_SATURATION:
        data = water.se[layer]
    elif var == OutputVariable.SOIL_TEMPERATURE:
        if heat is None:
            raise ValueError("soilTemperature requires the heat state")
        data = heat.t[layer]
    elif var == OutputVariable.FACTOR_OF_SAFETY:
        from criteria3d_tpu_torch.physics.crop import factor_of_safety
        if slope_deg is None:
            slope_deg = torch.zeros(grid.shape[1:], dtype=torch.float64,
                                    device=grid.device)
        fos = factor_of_safety(grid, params, water.h, water.se, slope_deg)
        data = fos[layer]
    else:
        raise ValueError(var)

    return where(mask, data, NODATA)


def _maps_by_name(grid, params, water, variables) -> dict:
    """``{"<var>_<depth>": map}`` of every configured (variable, depth)."""
    maps = {}
    for var, depths in variables.items():
        for d in depths:
            layer = layer_index_for_depth(grid, d) if d > 0 else 0
            maps[f"{var.value}_{d}"] = compute_variable_map(grid, params, water,
                                                            var, layer)
    return maps


@dataclasses.dataclass
class OutputPoints:
    """Output point set + time-series writer (agrolib/outputPoints).

    Points are (id, row, col) on the model grid; CSV lists with utm
    coordinates (outputPoints.h:9-15) are supported through ``from_csv``.
    """

    ids: list
    rows: list
    cols: list

    @staticmethod
    def from_csv(path: str, grid: Grid, xll=0.0, yll=0.0) -> "OutputPoints":
        ids, rows, cols = [], [], []
        R = grid.shape[1]
        with open(path) as f:
            for rec in csv.DictReader(f):
                x = float(rec.get("utm_x", rec.get("x", 0)))
                y = float(rec.get("utm_y", rec.get("y", 0)))
                col = int((x - xll) / grid.cell_size)
                row = R - 1 - int((y - yll) / grid.cell_size)
                if 0 <= row < R and 0 <= col < grid.shape[2]:
                    ids.append(rec.get("id", str(len(ids))))
                    rows.append(row)
                    cols.append(col)
        return OutputPoints(ids, rows, cols)

    def write_hour(self, db_path: str, time_str: str, grid: Grid,
                   params: SolverParameters, water: WaterState,
                   variables: dict[OutputVariable, list[int]],
                   extra_maps: dict | None = None) -> None:
        """Append one hour of values for every point into SQLite
        (dbOutputPointsHandler analogue): one table per point id. The
        maps' values at the points (``extra_maps``: tensors or arrays)
        come to the host in one copy."""
        maps = _maps_by_name(grid, params, water, variables)
        for name, vmap in (extra_maps or {}).items():
            maps[name] = torch.as_tensor(vmap, device=grid.device)
        names = list(maps)
        rows = torch.as_tensor(self.rows, dtype=torch.long, device=grid.device)
        cols = torch.as_tensor(self.cols, dtype=torch.long, device=grid.device)
        values = host_array(torch.stack(
            [maps[n][rows, cols].to(torch.float64) for n in names], dim=1))

        columns = ["time TEXT PRIMARY KEY"] + [f'"{n}" REAL' for n in names]
        con = sqlite3.connect(db_path)
        cur = con.cursor()
        for i, pid in enumerate(self.ids):
            table = f"point_{pid}"
            cur.execute(f'CREATE TABLE IF NOT EXISTS "{table}" '
                        f'({", ".join(columns)})')
            cur.execute(
                f'INSERT OR REPLACE INTO "{table}" (time, '
                + ", ".join(f'"{n}"' for n in names) + ") VALUES (?"
                + ", ?" * len(names) + ")",
                [time_str] + [float(v) for v in values[i]])
        con.commit()
        con.close()


def compute_output_rasters(out_dir: str, time_tag: str, grid: Grid,
                           params: SolverParameters, water: WaterState,
                           variables: dict[OutputVariable, list[int]]
                           ) -> list[tuple[str, torch.Tensor, RasterHeader]]:
    """Stage the hour's output maps on the device: ``(path, map, header)``
    tuples. The caller holds them across the next hour's dispatch and only
    then copies them to the host (:func:`flush_staged_rasters`), so that
    the copy of hour h waits behind hour h+1's queued work instead of
    stopping the host once per hour."""
    os.makedirs(out_dir, exist_ok=True)
    R, C = grid.shape[1:]
    hdr = RasterHeader(nrows=R, ncols=C, xllcorner=0, yllcorner=0,
                       cellsize=grid.cell_size, nodata=NODATA)
    return [(os.path.join(out_dir, f"{name}_{time_tag}"), vmap, hdr)
            for name, vmap in _maps_by_name(grid, params, water,
                                            variables).items()]


def flush_staged_rasters(staged, writer=None) -> list[str]:
    """Copy staged maps to the host (one counted copy each) and write each
    as an ESRI .flt/.hdr pair, or queue it on ``writer`` (a
    :class:`criteria3d_tpu_torch.native.AsyncRasterWriter`, which copies
    the host array); returns the .flt paths."""
    written = []
    for path, vmap, hdr in staged:
        if writer is not None:
            writer.submit(path, host_array(vmap), hdr)
        else:
            write_flt(path, host_array(vmap), hdr)
        written.append(path + ".flt")
    return written


def write_output_rasters(out_dir: str, time_tag: str, grid: Grid,
                         params: SolverParameters, water: WaterState,
                         variables: dict[OutputVariable, list[int]],
                         writer=None) -> list[str]:
    """Write one ESRI raster per (variable, depth), named
    ``<var>_<depthCm>_<time>`` like the reference's hourly output maps.

    ``writer`` (a :class:`criteria3d_tpu_torch.native.AsyncRasterWriter`)
    queues the file IO onto the native worker pool so it overlaps the next
    hour's work on the card; without one the writes are synchronous."""
    return flush_staged_rasters(
        compute_output_rasters(out_dir, time_tag, grid, params, water,
                               variables), writer=writer)

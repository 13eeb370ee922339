"""Model state checkpoint / resume as per-layer rasters.

PyTorch counterpart of ``criteria3d_tpu/io/state_io.py``, the reference's
directory-per-timestamp state scheme (Crit3DProject::saveModelsState /
loadModelState, criteria3DProject.cpp:2138-2257, 2834-2900):

* ``PATH_STATES/yyyyMMdd_HH/`` directory per checkpoint;
* water potential: one ESRI .flt raster per soil layer named
  ``WP_<depthCm>`` (matric potential [m]) + ``WP_0`` surface water level;
* snow state rasters (SWE, ice, liquid water, age, internal/surface energy,
  surface temperature);
* crop rasters (degree days, LAI).

The files are the JAX package's, byte for byte, for the same state. The
in-hour checkpoint keeps the whole float64 ``WaterState`` in one ``.npz``.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from criteria3d_tpu_torch.constants import NODATA
from criteria3d_tpu_torch.core.grid import Grid
from criteria3d_tpu_torch.core.state import (BalanceData, SolverParameters,
                                             WaterState)
from criteria3d_tpu_torch.device import resolve_device
from criteria3d_tpu_torch.io.esri import RasterHeader, read_flt, write_flt
from criteria3d_tpu_torch.physics.snow import SnowState
from criteria3d_tpu_torch.solver import water as W
from criteria3d_tpu_torch.solver.step import initialize_balance

__all__ = ["save_state", "load_state", "state_dir_name",
           "save_inhour_state", "load_inhour_state"]

SNOW_FIELDS = ("swe", "ice", "liquid", "internal_energy", "surface_energy",
               "surface_temp", "age")


def state_dir_name(year: int, month: int, day: int, hour: int) -> str:
    return f"{year:04d}{month:02d}{day:02d}_H{hour:02d}"


def _header_for(grid: Grid) -> RasterHeader:
    R, C = grid.shape[1:]
    return RasterHeader(nrows=R, ncols=C, xllcorner=0.0, yllcorner=0.0,
                        cellsize=grid.cell_size, nodata=NODATA)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_state(path: str, grid: Grid, water: WaterState,
               snow: SnowState | None = None,
               degree_days=None, lai=None) -> None:
    """Write the model state rasters into ``path`` (created)."""
    os.makedirs(path, exist_ok=True)
    hdr = _header_for(grid)
    mask = _np(grid.mask)

    # surface water level [m]
    swl = _np(water.surface_water_level(grid))
    write_flt(os.path.join(path, "WP_0"), np.where(mask[0], swl, NODATA), hdr)

    # per-layer matric potential [m]
    psi = _np(water.matric_potential(grid))
    for l in range(1, grid.n_layers):
        depth_cm = int(round(grid.layer_depth[l] * 100))
        write_flt(os.path.join(path, f"WP_{depth_cm}"),
                  np.where(mask[l], psi[l], NODATA), hdr)

    if snow is not None:
        for field in SNOW_FIELDS:
            write_flt(os.path.join(path, f"SNOW_{field}"),
                      np.where(mask[0], _np(getattr(snow, field)), NODATA), hdr)

    if degree_days is not None:
        write_flt(os.path.join(path, "degreeDays"),
                  np.where(mask[0], _np(degree_days), NODATA), hdr)
    if lai is not None:
        write_flt(os.path.join(path, "lai"),
                  np.where(mask[0], _np(lai), NODATA), hdr)


def load_state(path: str, grid: Grid, params: SolverParameters):
    """Read a checkpoint back onto the grid's device. Returns (water,
    snow | None, extras dict).

    Water potential is reconstructed as loadWaterPotentialState does:
    H = z + psi for soil nodes, H = z + water level for the surface."""
    dev = grid.device
    L = grid.n_layers

    def tensor(a):
        return torch.tensor(a, dtype=torch.float64, device=dev)

    swl, _ = read_flt(os.path.join(path, "WP_0"))
    psi_layers = [np.where(np.isclose(swl, NODATA), 0.0, swl)]
    for l in range(1, L):
        depth_cm = int(round(grid.layer_depth[l] * 100))
        data, _ = read_flt(os.path.join(path, f"WP_{depth_cm}"))
        psi_layers.append(np.where(np.isclose(data, NODATA), 0.0, data))
    psi = tensor(np.stack(psi_layers))

    h = grid.z + psi
    h = torch.where(grid.mask, h, 0.0)
    se = W.compute_se(grid, params, h)
    _, k = W.compute_capacity(grid, params, h, h, se)

    water = WaterState.initialize(grid, params, matric_potential=0.0, device=dev)
    water = dataclasses.replace(water, h=h, h_old=h, best_h=h, se=se, k=k)
    water = initialize_balance(grid, params, water)

    snow = None
    if os.path.exists(os.path.join(path, "SNOW_swe.flt")):
        fields = {}
        for field in SNOW_FIELDS:
            data, _ = read_flt(os.path.join(path, f"SNOW_{field}"))
            fields[field] = tensor(np.where(np.isclose(data, NODATA), 0.0, data))
        snow = SnowState(**fields)

    extras = {}
    for name in ("degreeDays", "lai"):
        f = os.path.join(path, f"{name}.flt")
        if os.path.exists(f):
            data, _ = read_flt(f)
            extras[name] = tensor(np.where(np.isclose(data, NODATA), 0.0, data))
    return water, snow, extras


# ----------------------------------------------------------------------
# in-hour restart (full precision): the reference pauses mid-hour and
# resumes at currentSeconds (runModelHour isRestart,
# criteria3DProject.cpp:2020; runWaterFluxes3DModel project3D.cpp:1307).
# The per-layer rasters above are float32, so an in-hour resume keeps the
# whole WaterState in its own dtypes.
# ----------------------------------------------------------------------

_BALANCES = ("balance_prev", "balance_current", "balance_period",
             "balance_whole")
_BAL_SCALARS = ("storage", "sink_source", "mbe", "mbr")
_ARRAY_FIELDS = ("h", "h_old", "best_h", "se", "k", "sink_source", "pond",
                 "boundary_flow_sum", "link_flow_sum", "dt_curr", "courant")


def save_inhour_state(path: str, water: WaterState,
                      elapsed_seconds: float) -> None:
    """Persist the mid-hour solver state + elapsed seconds (one .npz)."""
    arrays = {f: _np(getattr(water, f)) for f in _ARRAY_FIELDS}
    for b in _BALANCES:
        bal = getattr(water, b)
        for s in _BAL_SCALARS:
            arrays[f"{b}.{s}"] = _np(getattr(bal, s))
    arrays["elapsed_seconds"] = np.asarray(float(elapsed_seconds))
    np.savez(path, **arrays)


def load_inhour_state(path: str, *, device=None) -> tuple[WaterState, float]:
    """Restore a mid-hour checkpoint onto ``device`` (None means the CUDA
    card). Returns (water, elapsed_seconds); resume the hour with
    ``compute_period_stats(..., period_seconds=3600, start_seconds=elapsed)``."""
    dev = resolve_device(device)
    with np.load(path if str(path).endswith(".npz") else f"{path}.npz") as z:
        kw = {f: torch.from_numpy(z[f]).to(dev) for f in _ARRAY_FIELDS}
        for b in _BALANCES:
            kw[b] = BalanceData(**{s: torch.from_numpy(z[f"{b}.{s}"]).to(dev)
                                   for s in _BAL_SCALARS})
        elapsed = float(z["elapsed_seconds"])
    return WaterState(**kw), elapsed

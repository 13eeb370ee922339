"""Synthetic problems for the on-card checks (``chip_smoke.py``) and the
card tests (``tests/test_torch_cuda.py``).

- :func:`synthetic_catchment` and :func:`build_problem`: the storm hour of
  the repository's benchmark on a catchment at the scale of the Ravone
  benchmark (whose DEM is not in the repository).
- :func:`small_hour` with :data:`SMALL_CONFIGS`: a 16 x 16 valley hour with
  dt locked at 60 s, run on the card and on the CPU to hold the two
  against each other.
- :func:`build_coupled_problem`: the benchmark's coupled water + heat storm
  hour on the same catchment; :func:`small_coupled_hour` with
  :data:`SMALL_COUPLED_CONFIGS`: a coupled hour of a 6 x 6 heat column, for
  the card against the CPU.
- :func:`build_model_problem` and :func:`model_day_forcing`: the hourly
  model cycle on the same catchment (slope and aspect from the DEM) and a
  cold late-winter day of forcing: snow in the early morning, rain on the
  pack, then a dry afternoon.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from criteria3d_tpu_torch.core.grid import BoundaryType, Grid, slope_aspect
from criteria3d_tpu_torch.core.soil import SoilFields
from criteria3d_tpu_torch.core.state import SolverParameters, WaterState
from criteria3d_tpu_torch.model import Criteria3DModel, HourlyForcing, ModelConfig
from criteria3d_tpu_torch.physics.snow import SnowState
from criteria3d_tpu_torch.solver import coupled as C
from criteria3d_tpu_torch.solver import heat as H
from criteria3d_tpu_torch.solver.step import (compute_period_stats,
                                              initialize_balance)

__all__ = ["synthetic_catchment", "build_problem", "small_hour",
           "SMALL_CONFIGS", "build_coupled_problem", "heat_column",
           "small_coupled_hour", "SMALL_COUPLED_CONFIGS",
           "catchment_grid", "build_model_problem", "model_day_forcing",
           "MODEL_CONFIG", "small_model"]

# clay loam of the Ravone study
CLAY_LOAM = dict(vg_alpha=1.0, vg_n=1.35, vg_he=0.02, theta_s=0.44,
                 theta_r=0.06, k_sat=2e-6)
SMALL_SOIL = dict(vg_alpha=1.2, vg_n=1.5, vg_he=0.02, theta_s=0.41,
                  theta_r=0.04, k_sat=5e-6)

_LOCKED = dict(delta_t_min=60.0, delta_t_max=60.0)
# name -> (parameters, head tolerance card vs CPU [m]); link flows are held
# to 1e-3 of their max |value|
SMALL_CONFIGS = {
    "bundle": (lambda: SolverParameters.fast_f32(use_pallas=True, **_LOCKED), 1e-4),
    "f64": (lambda: SolverParameters(**_LOCKED), 1e-6),
    "cg_line": (lambda: SolverParameters.fast_f32(**_LOCKED), 1e-4),
    "cg_diag_links": (lambda: SolverParameters.fast_f32(
        cg_precond="diag", track_link_flow=True, **_LOCKED), 1e-4),
}


def synthetic_catchment(seed: int, n: int = 768, cell: float = 4.0,
                        radius: float = 366.0) -> np.ndarray:
    """A tilted V valley in the form of tests/test_catchment3d.py's
    valley_dem (5 % down-valley, 8 % across, per metre) plus a smooth seeded
    perturbation, inside a disc of valid cells centred in an n x n box."""
    rng = np.random.default_rng(seed)
    rows, cols = np.mgrid[0:n, 0:n].astype(np.float64)
    z = 100.0 + (n - 1 - rows) * 0.05 * cell + np.abs(cols - n // 2) * 0.08 * cell
    for _ in range(4):
        kr, kc = rng.uniform(-1, 1, 2) * 2 * np.pi / (100.0 * cell)
        z += rng.uniform(0.5, 2.0) * np.sin(kr * rows * cell + kc * cols * cell
                                            + rng.uniform(0, 2 * np.pi))
    c0 = (n - 1) / 2.0
    disc = (rows - c0) ** 2 + (cols - c0) ** 2 <= radius ** 2
    return np.where(disc, z, -9999.0)


def catchment_grid(dem, cell, device, *, total_depth=0.8, min_thickness=0.04,
                   max_thickness=0.25, max_thickness_depth=0.6, soil=None) -> Grid:
    """The benchmark's grid on ``dem``: clay loam (or ``soil``), 0.8 m of
    soil in layers of 0.04-0.25 m."""
    return Grid.build(dem, cell,
                      SoilFields.uniform(dem.shape, device=device,
                                         **(soil or CLAY_LOAM)),
                      total_depth=total_depth, min_thickness=min_thickness,
                      max_thickness=max_thickness,
                      max_thickness_depth=max_thickness_depth, device=device)


def build_problem(dem, cell, params, device, *, psi0=-2.0, rain=0.020, **grid_kw):
    """Grid + initial state + uniform rain [m/h] on the surface, as the
    benchmark builds its storm hour (``grid_kw``: :func:`catchment_grid`'s
    layers and soil)."""
    grid = catchment_grid(dem, cell, device, **grid_kw)
    state = WaterState.initialize(grid, params, matric_potential=psi0,
                                  device=device)
    state = initialize_balance(grid, params, state)
    sink = torch.zeros_like(state.sink_source)
    # a fill of the state's dtype: torch.where of two Python numbers is
    # float32
    sink[0] = torch.where(grid.mask[0],
                          torch.full_like(sink[0], rain * float(grid.area) / 3600.0),
                          0.0)
    return grid, dataclasses.replace(state, sink_source=sink)


def small_hour(params: SolverParameters, device, n: int = 16):
    """One hour of a 15 mm/h storm on an n x n valley (10 m cells, 0.6 m of
    soil in layers of 0.02-0.1 m, psi0 = -1.5 m); returns
    ``(final_state, stats)``."""
    rows, cols = np.mgrid[0:n, 0:n]
    dem = (100.0 + (n - 1 - rows) * 0.5
           + np.abs(cols - n // 2) * 0.8).astype(np.float64)
    grid, state = build_problem(dem, 10.0, params, device, total_depth=0.6,
                                min_thickness=0.02, max_thickness=0.1,
                                max_thickness_depth=0.4, soil=SMALL_SOIL,
                                psi0=-1.5, rain=0.015)
    return compute_period_stats(grid, params, state, 3600.0)


# ----------------------------------------------------------------------
# coupled water + heat
# ----------------------------------------------------------------------

def with_heat_surface(grid: Grid) -> Grid:
    """Every valid layer-1 node becomes an atmospheric HeatSurface node
    with a boundary the size of the cell."""
    btype, bsize = grid.btype.clone(), grid.bsize.clone()
    btype[1] = torch.where(grid.mask[1], int(BoundaryType.HEAT_SURFACE), btype[1])
    bsize[1] = torch.where(grid.mask[1], torch.full_like(bsize[1], float(grid.area)),
                           bsize[1])
    return dataclasses.replace(grid, btype=btype, bsize=bsize)


def initial_heat(grid: Grid, params: SolverParameters, water: WaterState,
                 t0: float, **forcing):
    """Uniform temperature ``t0`` [K] with the storage balance set to the
    initial storage, and uniform atmospheric forcing on the HeatSurface
    nodes (``forcing``: HeatBoundary.uniform's keywords)."""
    heat = H.initialize_heat(grid, t0)
    storage = H.heat_storage(grid, params, heat, water)
    heat = dataclasses.replace(heat, storage_prev=storage, storage_whole=storage)
    mask = grid.btype[1] == int(BoundaryType.HEAT_SURFACE)
    return heat, H.HeatBoundary.uniform(grid.shape[1:], mask=mask,
                                        device=grid.device, **forcing)


def build_coupled_problem(dem, cell, params, device, **kw):
    """The coupled storm hour of the repository's benchmark (bench.py's
    coupled leg): build_problem's storm with every valid layer-1 node a
    HeatSurface, soil at 288.15 K, air at 291.15 K, 85 % relative
    humidity, 3 m/s wind and 80 W/m2 net irradiance. Returns ``(grid,
    water, heat, boundary)``."""
    grid, water = build_problem(dem, cell, params, device, **kw)
    grid = with_heat_surface(grid)
    heat, boundary = initial_heat(grid, params, water, 288.15,
                                  air_temperature=291.15, rel_humidity=85.0,
                                  wind_speed=3.0, net_irradiance=80.0)
    return grid, water, heat, boundary


def heat_column(params: SolverParameters, device, n: int = 6,
                total_depth: float = 0.6):
    """tests/test_coupled.py's heat-parity column: an n x n plot (2 m
    cells, a 0.1 m step per column), no drainage boundaries, HeatSurface
    layer 1, psi0 = -2 m, soil at 283.15 K under air at 298.15 K, 50 %
    relative humidity, 2 m/s wind and 300 W/m2. Returns ``(grid, water,
    heat, boundary)``."""
    dem = np.zeros((n, n)) + np.arange(n)[None, :] * 0.1
    soil = SoilFields.uniform((n, n), device=device, vg_alpha=1.4, vg_n=1.6,
                              vg_he=0.02, theta_s=0.43, theta_r=0.05, k_sat=1e-5)
    grid = with_heat_surface(Grid.build(
        dem, 2.0, soil, total_depth=total_depth, free_catchment_runoff=False,
        free_bottom_drainage=False, free_lateral_drainage=False, device=device))
    water = initialize_balance(grid, params, WaterState.initialize(
        grid, params, matric_potential=-2.0, device=device))
    heat, boundary = initial_heat(grid, params, water, 283.15,
                                  air_temperature=298.15, rel_humidity=50.0,
                                  wind_speed=2.0, net_irradiance=300.0)
    return grid, water, heat, boundary


# name -> (parameters, temperature tolerance [K], head tolerance [m]) of
# the small coupled hours held card against CPU
SMALL_COUPLED_CONFIGS = {
    "f64_vapor": (lambda: SolverParameters(heat_vapor=True), 1e-6, 1e-6),
    "frozen_vapor": (lambda: SolverParameters.fast_f32(
        heat_vapor=True, heat_frozen_props=True), 1e-3, 1e-4),
}


def small_coupled_hour(params: SolverParameters, device):
    """One coupled hour of :func:`heat_column`; returns ``(water, heat,
    counts)`` with the coupled step's counts of that hour."""
    grid, water, heat, boundary = heat_column(params, device)
    C.reset_counts()
    water, heat = C.compute_period_coupled(grid, params, water, heat,
                                           boundary, 3600.0)
    return water, heat, C.counts()


# ----------------------------------------------------------------------
# the hourly model cycle
# ----------------------------------------------------------------------

# every process the port runs (HYDRALL and RothC are not ported), at
# ModelConfig's site: 44.5 N, 11.3 E, UTC+1
MODEL_CONFIG = dict(compute_snow=True, compute_crop=True,
                    compute_evaporation=True, compute_interception=True,
                    compute_cracking=True)
# the snow model's ground [degC]: frozen after a frosty night, so that the
# morning's snow settles
GROUND_TEMPERATURE = -2.0


def build_model_problem(dem, cell, params, device,
                        config: ModelConfig) -> Criteria3DModel:
    """A :class:`Criteria3DModel` on ``dem`` (:func:`catchment_grid`,
    psi0 = -2 m, the default crop, the snow ground at
    :data:`GROUND_TEMPERATURE`), with ``slope_deg`` and ``aspect_deg`` from
    :func:`slope_aspect` of the DEM as the JAX package's project loader
    sets them (project.py:344-345), so that the inclined-surface radiation
    runs. ``config.compute_heat`` makes every valid layer-1 node a
    HeatSurface."""
    grid = catchment_grid(dem, cell, device)
    if config.compute_heat:
        grid = with_heat_surface(grid)
    model = Criteria3DModel.create(grid, params, config, matric_potential=-2.0)
    if config.compute_snow:
        model.snow = SnowState.zero(dem.shape, surface_temp=GROUND_TEMPERATURE,
                                    device=grid.device)
    valid = ~np.isclose(dem, -9999.0)
    slope, aspect = slope_aspect(dem, cell)
    model.slope_deg = torch.tensor(np.where(valid, slope, 0.0), device=grid.device)
    model.aspect_deg = torch.tensor(np.where(valid, aspect, 0.0), device=grid.device)
    return model


# the day of model_day_forcing, hour by hour: air temperature at the
# catchment's mean valid elevation [degC]; precipitation [mm/h] (snow at
# 6-7, rain on the pack at 8-9, dry otherwise)
DAY_AIR_TEMPERATURE = (-2.5, -2.8, -3.0, -3.2, -3.0, -2.2, -1.5, -1.0, 1.5,
                       2.5, 5.0, 7.0, 8.0, 8.5, 8.5, 8.0, 7.0, 5.5, 4.0, 2.5,
                       1.5, 0.5, -0.5, -1.5)
DAY_PRECIPITATION = {6: 3.0, 7: 3.0, 8: 8.0, 9: 8.0}
LAPSE_RATE = 0.0065   # [K m-1]


def model_day_forcing(grid: Grid, date, hour: int) -> HourlyForcing:
    """The hourly forcing of a cold day (``date`` sets nothing; the
    signature is run_period's provider's): air temperature from
    :data:`DAY_AIR_TEMPERATURE` at the mean valid elevation, less 0.0065 K
    for every metre above it; 90 % relative humidity and transmissivity
    0.3 while it precipitates, 65 % and 0.7 otherwise; wind 2 m/s (3 m/s
    in the rain). Maps on the grid's device."""
    valid = grid.mask[0]
    z = grid.z[0]
    mean_z = torch.sum(torch.where(valid, z, 0.0)) / torch.sum(valid)
    t = DAY_AIR_TEMPERATURE[hour] - LAPSE_RATE * (z - mean_z)
    prec = DAY_PRECIPITATION.get(hour, 0.0)
    wet = prec > 0.0

    def full(v):
        return torch.full_like(z, v)

    return HourlyForcing(
        air_temperature=torch.where(valid, t, DAY_AIR_TEMPERATURE[hour]),
        precipitation=full(prec),
        rel_humidity=full(90.0 if wet else 65.0),
        wind_speed=full(3.0 if prec > 5.0 else 2.0),
        transmissivity=full(0.3 if wet else 0.7))


def small_model(params: SolverParameters, device, n: int = 32) -> Criteria3DModel:
    """:func:`build_model_problem` with :data:`MODEL_CONFIG` on the
    synthetic catchment cut to an n x n box (4 m cells, the disc scaled
    with the box), for the card against the CPU."""
    dem = synthetic_catchment(0, n=n, radius=n * 366.0 / 768)
    return build_model_problem(dem, 4.0, params, device, ModelConfig(**MODEL_CONFIG))

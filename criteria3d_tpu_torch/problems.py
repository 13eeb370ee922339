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
  pack, then a dry afternoon; :func:`build_hydrall_problem` adds HYDRALL
  and RothC over a seeded forest.
- :func:`write_project` and :func:`write_vine_project`: a CRITERIA3D
  project and a VINE3D project on disk that both packages load;
  :func:`dem_as_geotiff` rewrites a project's DEM as a GeoTIFF and
  :func:`write_meteo_grid` writes a meteo grid DB over its box.
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

__all__ = ["synthetic_catchment", "build_problem", "storm_state", "small_hour",
           "SMALL_CONFIGS", "build_coupled_problem", "heat_column",
           "coupled_storm", "coupled_box", "small_coupled_hour", "SMALL_COUPLED_CONFIGS",
           "catchment_grid", "build_model_problem", "model_day_forcing",
           "MODEL_CONFIG", "small_model", "write_project", "HYDRALL_CONFIG",
           "forest_mask", "build_hydrall_problem", "small_hydrall_model",
           "write_vine_project", "seed_vine_canopy", "VINE_DATE", "VINE_CANOPY",
           "dem_as_geotiff", "write_meteo_grid"]

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
    return grid, storm_state(grid, params, psi0=psi0, rain=rain)


def storm_state(grid: Grid, params: SolverParameters, psi0: float = -2.0,
                rain: float = 0.020) -> WaterState:
    """The initial state of the benchmark's storm on ``grid``: uniform
    matric potential ``psi0`` [m], the balance set to its storage, and
    ``rain`` [m/h] on the surface."""
    state = WaterState.initialize(grid, params, matric_potential=psi0,
                                  device=grid.device)
    state = initialize_balance(grid, params, state)
    sink = torch.zeros_like(state.sink_source)
    # a fill of the state's dtype: torch.where of two Python numbers is
    # float32
    sink[0] = torch.where(grid.mask[0],
                          torch.full_like(sink[0], rain * float(grid.area) / 3600.0),
                          0.0)
    return dataclasses.replace(state, sink_source=sink)


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
    return coupled_storm(grid, params, water)


def coupled_storm(grid: Grid, params: SolverParameters, water: WaterState):
    """:func:`build_coupled_problem`'s hour on ``grid`` from the storm
    state ``water``: ``(grid with HeatSurface nodes, water, heat,
    boundary)``."""
    grid = with_heat_surface(grid)
    heat, boundary = initial_heat(grid, params, water, 288.15,
                                  air_temperature=291.15, rel_humidity=85.0,
                                  wind_speed=3.0, net_irradiance=80.0)
    return grid, water, heat, boundary


def coupled_box(params: SolverParameters, device, n: int, irradiance: float = 80.0):
    """:func:`build_coupled_problem`'s storm on an n x n box of
    ``synthetic_catchment(3)`` (the disc's radius 0.45 n) under
    ``irradiance`` W/m2 of net radiation: the coupled machine's small cases
    (tests/test_torch_coupled_machine.py's 12 box, the card's 32 box).
    Returns ``(grid, water, heat, boundary)``."""
    grid, water = build_problem(synthetic_catchment(3, n=n, radius=n * 0.45), 4.0,
                                params, device)
    grid = with_heat_surface(grid)
    heat, boundary = initial_heat(grid, params, water, 288.15, air_temperature=291.15,
                                  rel_humidity=85.0, wind_speed=3.0,
                                  net_irradiance=irradiance)
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


# ----------------------------------------------------------------------
# a project on disk
# ----------------------------------------------------------------------

PROJECT_DATE = (2023, 3, 21)
PROJECT_SITE = (44.5, 11.3)      # lat, lon [deg]: UTM zone 32, UTC+1
# hour, station index and excess [degC] of the broken reading that spatial
# QC turns away
PROJECT_OUTLIER = (8, 1, 25.0)
# output points (ids) and the [output] depth lists [cm]
PROJECT_OUTPUTS = dict(watercontent="10, 30", waterpotential="10",
                       factorofsafety="30")

# USDA texture class -> van Genuchten defaults (alpha [kPa-1], n, he
# [kPa], theta_r, theta_s, k_sat [cm/d], l), the layout of the
# reference's van_genuchten table
_VG_CLASSES = {
    1: (1.46, 2.68, 0.05, 0.045, 0.43, 712.8, 0.5),
    2: (1.26, 2.28, 0.05, 0.057, 0.41, 350.2, 0.5),
    3: (0.77, 1.89, 0.1, 0.065, 0.41, 106.1, 0.5),
    4: (0.20, 1.41, 0.2, 0.067, 0.45, 10.8, 0.5),
    5: (0.36, 1.56, 0.2, 0.078, 0.43, 24.96, 0.5),
    6: (0.16, 1.37, 0.3, 0.034, 0.46, 6.0, 0.5),
    7: (0.60, 1.48, 0.3, 0.1, 0.39, 31.44, 0.5),
    8: (0.10, 1.23, 0.5, 0.089, 0.43, 1.68, 0.5),
    9: (0.19, 1.31, 0.5, 0.095, 0.41, 6.24, 0.5),
    10: (0.27, 1.23, 0.5, 0.1, 0.38, 2.88, 0.5),
    11: (0.05, 1.09, 0.8, 0.07, 0.36, 0.48, 0.5),
    12: (0.08, 1.09, 0.8, 0.068, 0.38, 4.8, 0.5),
}
# (soil_code, id_soil, [(horizon, upper cm, lower cm, sand, silt, clay,
# k_sat [cm/d] or None for the texture class's)]); the clay loam's
# measured k_sat lets the day's 8 mm/h rain soak in
_SOILS = [
    ("CL", 1, [(1, 0, 20, 30.0, 35.0, 35.0, 25.0), (2, 20, 50, 25.0, 40.0, 35.0, 20.0),
               (3, 50, 80, 20.0, 45.0, 35.0, 15.0)]),
    ("SL", 2, [(1, 0, 10, 65.0, 25.0, 10.0, None), (2, 10, 25, 60.0, 28.0, 12.0, None)]),
]


def _write_soil_db(path: str) -> None:
    """soils, horizons, van_genuchten and, for horizon 2 of the clay loam,
    water_retention (six points of a van Genuchten curve, so that
    ``read_soil_db`` fits it)."""
    import sqlite3
    con = sqlite3.connect(path)
    con.execute("CREATE TABLE soils (id_soil INTEGER, soil_code TEXT, "
                "name TEXT, info TEXT)")
    con.execute("CREATE TABLE horizons (soil_code TEXT, horizon_nr INTEGER, "
                "upper_depth REAL, lower_depth REAL, coarse_fragment REAL, "
                "organic_matter REAL, sand REAL, silt REAL, clay REAL, "
                "bulk_density REAL, theta_sat REAL, k_sat REAL, "
                "effective_cohesion REAL, friction_angle REAL)")
    con.execute("CREATE TABLE van_genuchten (id_texture INTEGER, alpha REAL, "
                "n REAL, he REAL, theta_r REAL, theta_s REAL, k_sat REAL, "
                "l REAL)")
    con.execute("CREATE TABLE water_retention (soil_code TEXT, "
                "horizon_nr INTEGER, water_potential REAL, water_content REAL)")
    con.executemany("INSERT INTO van_genuchten VALUES (?,?,?,?,?,?,?,?)",
                    [(k,) + v for k, v in _VG_CLASSES.items()])
    for code, id_soil, horizons in _SOILS:
        con.execute("INSERT INTO soils VALUES (?,?,?,?)",
                    (id_soil, code, f"synthetic {code}", ""))
        for nr, up, low, sand, silt, clay, k_sat in horizons:
            con.execute("INSERT INTO horizons VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
                        (code, nr, up, low, 0.05, 2.0, sand, silt, clay, 1.35,
                         None, k_sat, 5.0, 30.0))
    kpa = np.array([1.0, 10.0, 33.0, 100.0, 500.0, 1500.0])
    psi = kpa / 9.80665
    theta = 0.07 + 0.37 * (1.0 + (1.1 * psi) ** 1.35) ** (-(1.0 - 1.0 / 1.35))
    con.executemany("INSERT INTO water_retention VALUES (?,?,?,?)",
                    [("CL", 2, float(p), float(t)) for p, t in zip(kpa, theta)])
    con.commit()
    con.close()


def _write_crop_db(path: str) -> None:
    """crop (one grass) and land_units: the crop unit, an URBAN strip, a
    ROAD line and a FOREST patch (ids 1-4 of the land-use map)."""
    import sqlite3
    con = sqlite3.connect(path)
    con.execute("CREATE TABLE crop (id_crop TEXT, crop_name TEXT, lai_min REAL, "
                "lai_max REAL, thermal_threshold REAL, upper_thermal_threshold "
                "REAL, degree_days_emergence REAL, degree_days_lai_increase "
                "REAL, degree_days_lai_decrease REAL, lai_curve_factor_a REAL, "
                "lai_curve_factor_b REAL, root_depth_zero REAL, root_depth_max "
                "REAL, root_shape_deformation REAL, degree_days_root_increase "
                "REAL, kc_max REAL, raw_fraction REAL)")
    con.execute("INSERT INTO crop VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
                ("GRASS", "meadow", 1.0, 3.5, 5.0, 30.0, 50.0, 900.0, 2000.0,
                 4.0, 0.012, 0.05, 0.6, 1.2, 800.0, 1.1, 0.5))
    con.execute("CREATE TABLE land_units (id_unit INTEGER, name TEXT, "
                "id_landuse TEXT, id_crop TEXT, roughness REAL, pond REAL)")
    con.executemany("INSERT INTO land_units VALUES (?,?,?,?,?,?)", [
        (1, "meadow", "HERBACEOUS", "GRASS", 0.24, 0.002),
        (2, "village", "URBAN", None, 0.015, 0.0005),
        (3, "road", "ROAD", None, 0.013, 0.0002),
        (4, "wood", "FOREST", None, 0.4, 0.004)])
    con.commit()
    con.close()


def _station_weather(rng, hour: int, z: float, pot: float) -> dict:
    """One station's observations at ``hour`` of the cold day of
    :func:`model_day_forcing`, at altitude ``z`` [m]: a thermal inversion
    (warming 8 K/km up to 400 m) before 9 h, 6.5 K/km cooling after;
    precipitation at 6-9 h; ``pot`` the site's clear-sky irradiance."""
    base = DAY_AIR_TEMPERATURE[hour]
    if hour < 9:
        t = base + 0.008 * (min(z, 400.0) - 200.0) - 0.0065 * max(z - 400.0, 0.0)
    else:
        t = base - 0.0065 * (z - 200.0)
    prec = DAY_PRECIPITATION.get(hour, 0.0)
    wet = prec > 0.0
    return {
        "t": t + rng.normal(0.0, 0.15),
        "prec": max(prec * (1.0 + 0.1 * rng.normal()), 0.0),
        "rh": float(np.clip((90.0 if wet else 65.0) + rng.normal(0.0, 3.0),
                            30.0, 100.0)),
        "wind": (3.0 if prec > 5.0 else 2.0) + rng.uniform(-0.5, 0.5),
        "rad": max(pot * (0.3 if wet else 0.7) * (1.0 + 0.05 * rng.normal()), 0.0),
    }


def _site_clear_sky(day) -> list:
    """The site's clear-sky irradiance [W m-2] at each of the 24 hours of
    ``day`` (year, month, day; local time, UTC+1), Linke turbidity 4."""
    from criteria3d_tpu_torch.physics import radiation as rad_mod
    lat0, lon0 = PROJECT_SITE
    pots = []
    for hour in range(24):
        sun = rad_mod.sun_position(torch.tensor(lat0, dtype=torch.float64), lon0, 1,
                                   *day, hour)
        pots.append(float(rad_mod.clear_sky_beam_horizontal(4.0, sun)
                          + rad_mod.clear_sky_diffuse_horizontal(4.0, sun)))
    return pots


def _write_stations(path: str, hdr, zone: int, n_stations: int, rng, day,
                    weather, outlier=None) -> None:
    """Write ``n_stations`` stations and their 24 hourly readings of ``day``
    (year, month, day; local time, UTC+1) into a new meteo-points DB at
    ``path``: the stations stand on a lattice at half the box's width
    (tied distances; some outside the DEM) at altitudes spread over 60-660
    m; ``weather(rng, hour, z, pot)`` gives one station's readings, ``pot``
    the site's clear-sky irradiance; ``outlier`` (hour, station, excess
    [degC]) breaks one temperature."""
    import datetime

    from criteria3d_tpu_torch.core.geo import utm_to_latlon
    from criteria3d_tpu_torch.core.meteo import MeteoVariable
    from criteria3d_tpu_torch.io.meteopoints import MeteoPointsDB

    lat0, lon0 = PROJECT_SITE
    width = hdr.nrows * hdr.cellsize
    cx, cy = hdr.xllcorner + width / 2, hdr.yllcorner + width / 2
    n_cols = int(np.ceil(np.sqrt(n_stations)))
    n_rows = int(np.ceil(n_stations / n_cols))
    spacing = width / 2
    alt = 60.0 + 600.0 * np.arange(n_stations) / max(n_stations - 1, 1)
    alt = rng.permutation(alt)
    date = datetime.datetime(*day)
    pots = _site_clear_sky(day)
    o_hour, o_station, o_excess = outlier or (None, None, 0.0)
    variables = (("t", MeteoVariable.AIR_TEMPERATURE),
                 ("prec", MeteoVariable.PRECIPITATION),
                 ("rh", MeteoVariable.AIR_REL_HUMIDITY),
                 ("wind", MeteoVariable.WIND_SCALAR_INTENSITY),
                 ("rad", MeteoVariable.GLOBAL_IRRADIANCE))
    with MeteoPointsDB(path, create=True) as db:
        for i in range(n_stations):
            r, c = divmod(i, n_cols)
            x = cx + (c - (n_cols - 1) / 2) * spacing
            y = cy + (r - (n_rows - 1) / 2) * spacing
            lat, lon = utm_to_latlon(zone, lat0, x, y)
            sid = f"S{i:02d}"
            db.write_point_properties(id_point=sid, name=f"station {i}",
                                      latitude=float(lat), longitude=float(lon),
                                      utm_x=x, utm_y=y, altitude=float(alt[i]))
            series = {k: [] for k, _ in variables}
            for hour in range(24):
                w = weather(rng, hour, float(alt[i]), pots[hour])
                if (hour, i) == (o_hour, o_station):
                    w["t"] += o_excess
                for k, _ in variables:
                    series[k].append(w[k])
            for k, var in variables:
                db.write_hourly(sid, var, date, series[k])


def project_dem(n: int, seed: int):
    """The DEM of :func:`write_project` (``n``, ``seed``) as a project
    loads it from its ``.flt`` (float32 values as float64) and its header:
    :func:`synthetic_catchment` on an n x n box of 4 m cells in UTM zone 32
    at 44.5 N, 11.3 E."""
    from criteria3d_tpu_torch.core.geo import latlon_to_utm
    from criteria3d_tpu_torch.io.esri import RasterHeader

    cell = 4.0
    x0, y0, _ = latlon_to_utm(*PROJECT_SITE, 32)
    width = n * cell
    hdr = RasterHeader(nrows=n, ncols=n, xllcorner=float(round(float(x0) - width / 2)),
                       yllcorner=float(round(float(y0) - width / 2)), cellsize=cell)
    dem = synthetic_catchment(seed, n=n, radius=n * 366.0 / 768)
    return dem.astype(np.float32).astype(np.float64), hdr


def write_project(dirpath: str, *, n: int, seed: int, n_stations: int,
                  compute_heat: bool = False) -> str:
    """Write a synthetic CRITERIA3D project under ``dirpath`` with numpy
    and sqlite3 only, so that the JAX package and the port load the same
    files; returns the path of its ini.

    - MAPS/: the DEM (:func:`synthetic_catchment` on an n x n box of 4 m
      cells in UTM zone 32 at 44.5 N, 11.3 E), a two-soil map (clay loam
      west, sandy loam east) and a land-use map (a meadow with an URBAN
      strip, a ROAD line and a FOREST patch), as .flt;
    - DATA/soil.db (soils, horizons, van_genuchten, water_retention for one
      horizon), DATA/crop.db (crop, land_units), DATA/meteo.db (the
      stations, written by :class:`MeteoPointsDB`) and
      DATA/output_points.csv (three points);
    - <name>.ini ([location], [project], [settings], [simulation],
      [output]) and parameters.ini ([soilWaterFluxes] at a 0.35 m
      computation depth and accuracy 3, [radiation], [interpolation],
      [meteo], [climate]).

    The ``n_stations`` stations stand on a lattice at half the box's width
    (tied distances; some stand outside the DEM) at altitudes spread over
    60-660 m, and report the 24 hours of 2023-03-21 (local time, UTC+1):
    the cold day of :func:`model_day_forcing` with a thermal inversion
    before 9 h, and at :data:`PROJECT_OUTLIER` one broken temperature."""
    import os

    from criteria3d_tpu_torch.core.geo import latlon_to_utm
    from criteria3d_tpu_torch.io.esri import write_flt

    lat0, lon0 = PROJECT_SITE
    _, _, zone = latlon_to_utm(lat0, lon0, 32)
    for sub in ("MAPS", "DATA"):
        os.makedirs(os.path.join(dirpath, sub), exist_ok=True)

    # --- maps
    dem, hdr = project_dem(n, seed)
    valid = dem != -9999.0
    rows, cols = np.mgrid[0:n, 0:n]
    soil_map = np.where(cols < 0.6 * n, 1.0, 2.0)
    land = np.ones((n, n))
    land[(rows >= 0.15 * n) & (rows < 0.2 * n + 1)] = 2.0
    land[:, int(0.7 * n)] = 3.0
    land[(rows >= 0.6 * n) & (rows < 0.8 * n) & (cols >= 0.2 * n) & (cols < 0.4 * n)] = 4.0
    for name, data in (("dem", dem), ("soil", np.where(valid, soil_map, -9999.0)),
                       ("landuse", np.where(valid, land, -9999.0))):
        write_flt(os.path.join(dirpath, "MAPS", name), data, hdr)

    # --- databases and the output points
    _write_soil_db(os.path.join(dirpath, "DATA", "soil.db"))
    _write_crop_db(os.path.join(dirpath, "DATA", "crop.db"))
    with open(os.path.join(dirpath, "DATA", "output_points.csv"), "w") as f:
        f.write("id,utm_x,utm_y\n")
        for pid, (r, c) in zip(("P1", "P2", "P3"),
                               ((n // 2, n // 2), (n // 2 + n // 8, n // 4 + 1),
                                (n // 2 - n // 8, 3 * n // 4))):
            x, y = hdr.xy(r, c)
            f.write(f"{pid},{x},{y}\n")

    # --- stations
    _write_stations(os.path.join(dirpath, "DATA", "meteo.db"), hdr, zone,
                    n_stations, np.random.default_rng(seed), PROJECT_DATE,
                    _station_weather, outlier=PROJECT_OUTLIER)

    # --- the ini files
    ini = os.path.join(dirpath, "synthetic.ini")
    with open(ini, "w") as f:
        f.write(f"""[location]
lat = {lat0}
lon = {lon0}
utm_zone = {zone}
time_zone = 1
is_utc = false

[project]
name = synthetic
dem = MAPS/dem
meteo_points = DATA/meteo.db
soil_map = MAPS/soil
soil_db = DATA/soil.db
landuse_map = MAPS/landuse
crop_db = DATA/crop.db
output_points = DATA/output_points.csv
output_db = OUTPUT/output_points.db

[settings]
parameters_file = parameters.ini

[simulation]
compute_heat = {str(compute_heat).lower()}

[output]
waterContent = {PROJECT_OUTPUTS["watercontent"]}
waterPotential = {PROJECT_OUTPUTS["waterpotential"]}
factorOfSafety = {PROJECT_OUTPUTS["factorofsafety"]}
""")
    monthly = lambda v: ", ".join(str(x) for x in v)
    with open(os.path.join(dirpath, "parameters.ini"), "w") as f:
        f.write(f"""[soilWaterFluxes]
isInitialWaterPotential = true
initialWaterPotential = -2.0
computeAllSoilDepth = false
imposedComputationDepth = 0.35
conductivityHorizVertRatio = 10
freeCatchmentRunoff = true
freeBottomDrainage = true
freeLateralDrainage = true
modelAccuracy = 3

[radiation]
linke = 4.0
albedo = 0.2
clear_sky = 0.75

[interpolation]
minRegressionR2 = 0.1
algorithm = idw
thermalInversion = true
useDewPoint = true

[meteo]
prec_threshold = 0.2
wind_intensity_default = 2.0

[climate]
tmin = {monthly([-1.0, 0.0, 3.0, 7.0, 11.0, 15.0, 17.0, 17.0, 13.0, 9.0, 4.0, 0.0])}
tmax = {monthly([6.0, 9.0, 14.0, 18.0, 23.0, 27.0, 30.0, 30.0, 25.0, 19.0, 12.0, 7.0])}
tdmin = {monthly([-4.0, -3.0, -1.0, 3.0, 7.0, 11.0, 13.0, 13.0, 10.0, 6.0, 1.0, -3.0])}
tdmax = {monthly([2.0, 3.0, 5.0, 9.0, 13.0, 16.0, 18.0, 18.0, 15.0, 11.0, 6.0, 3.0])}
tmin_lapserate = {monthly([-0.004] * 12)}
tmax_lapserate = {monthly([-0.0065] * 12)}
tdmin_lapserate = {monthly([-0.002] * 12)}
tdmax_lapserate = {monthly([-0.003] * 12)}
""")
    return ini


def dem_as_geotiff(ini: str) -> str:
    """Rewrite the DEM of a :func:`write_project` project as an
    uncompressed float32 GeoTIFF (``MAPS/dem.tif``, the writer of
    ``io/geotiff.py``), remove its ``.flt``/``.hdr`` and point the ini at
    the ``.tif``; returns the GeoTIFF's path."""
    import os

    from criteria3d_tpu_torch.io.esri import read_flt
    from criteria3d_tpu_torch.io.geotiff import write_geotiff

    base = os.path.join(os.path.dirname(ini), "MAPS", "dem")
    dem, hdr = read_flt(base + ".flt")
    write_geotiff(base + ".tif", dem, hdr)
    os.remove(base + ".flt")
    os.remove(base + ".hdr")
    with open(ini) as f:
        text = f.read()
    assert "\ndem = MAPS/dem\n" in text
    with open(ini, "w") as f:
        f.write(text.replace("\ndem = MAPS/dem\n", "\ndem = MAPS/dem.tif\n"))
    return base + ".tif"


def valley_plane(fr, fc, n: int, cell: float):
    """The height of :func:`synthetic_catchment`'s valley plane (without its
    perturbation) at fractional raster row ``fr`` and column ``fc``."""
    return 100.0 + (n - 1 - fr) * 0.05 * cell + np.abs(fc - n // 2) * 0.08 * cell


def meteo_grid_cells(dem, hdr, *, cell: float, margin: float):
    """The cells of :func:`write_meteo_grid`'s grid over ``dem``'s box:
    ``(n_cells, xll, yll, [(row, col, x, y, z), ...])`` in row-major order
    from the south row, each centre's height the DEM's there, or where the
    centre falls off the catchment the valley plane's (:func:`valley_plane`)."""
    n = hdr.nrows
    width = n * hdr.cellsize
    n_cells = int((width + 2 * margin) // cell)
    xll = hdr.xllcorner + width / 2 - n_cells * cell / 2
    yll = hdr.yllcorner + width / 2 - n_cells * cell / 2
    cells = []
    for row in range(n_cells):
        for col in range(n_cells):
            x = xll + (col + 0.5) * cell
            y = yll + (row + 0.5) * cell
            # the centre in DEM cell units (raster row 0 = north)
            fc = (x - hdr.xllcorner) / hdr.cellsize - 0.5
            fr = n - 0.5 - (y - hdr.yllcorner) / hdr.cellsize
            r, c = int(round(fr)), int(round(fc))
            if 0 <= r < n and 0 <= c < n and dem[r, c] != hdr.nodata:
                z = float(dem[r, c])
            else:
                z = float(valley_plane(fr, fc, n, hdr.cellsize))
            cells.append((row, col, x, y, z))
    return n_cells, xll, yll, cells


def library_stations(n: int, seed: int, *, cell: float, margin: float, hour: int = 7):
    """Stations for the interpolation library at the scale of a project:
    :func:`write_meteo_grid`'s grid cells (``cell``, ``margin``) over
    :func:`project_dem`'s box as stations, heights from the DEM, each with
    the air temperature of :func:`write_project`'s weather rule at
    ``hour`` (a thermal inversion before 9 h). Returns ``(dem, header,
    x, y, z, t)``, the last four numpy arrays."""
    dem, hdr = project_dem(n, seed)
    _, _, _, cells = meteo_grid_cells(dem, hdr, cell=cell, margin=margin)
    x, y, z = (np.array([c[i] for c in cells]) for i in (2, 3, 4))
    rng = np.random.default_rng(seed)
    t = np.array([_station_weather(rng, hour, float(zz), 0.0)["t"] for zz in z])
    return dem, hdr, x, y, z, t


def write_meteo_grid(dirpath: str, ini: str, *, cell: float, margin: float,
                     seed: int) -> tuple[str, str]:
    """Write a meteo grid DB in the ERG5/COSMO style over the box of the
    project at ``ini`` (a :func:`write_project` project) with numpy and
    sqlite3 only, so that both packages load it; returns the paths of its
    XML and its sqlite DB (``DATA/grid.xml`` and ``DATA/grid.db`` under
    ``dirpath``).

    The grid is regular and in UTM: square cells of ``cell`` metres over
    the DEM's box widened by ``margin`` metres a side (as many whole cells
    as fit, centred on the box; row 0 the south row). Every cell is active;
    its CellsProperties height is the DEM's at the cell centre, or, where
    the centre falls off the catchment, the height of the valley's plane
    surface there (:func:`synthetic_catchment` without its perturbation).
    Each cell reports the 24 hours of 2023-03-21 (local time) under the
    stations' weather rule of :func:`write_project` at its height (the
    thermal inversion before 9 h, 6.5 K/km after, precipitation at 6-9 h),
    in the long per-cell hourly tables (PragaTime, VariableCode, Value)
    with the reference's variable codes. The same arguments give the same
    bytes."""
    import datetime
    import os
    import sqlite3

    from criteria3d_tpu_torch.core.meteo import HOURLY_DB_IDS, MeteoVariable
    from criteria3d_tpu_torch.io.config import load_project_ini
    from criteria3d_tpu_torch.io.esri import read_raster

    dem, hdr = read_raster(load_project_ini(ini).dem_path)
    n_cells, xll, yll, cells = meteo_grid_cells(dem, hdr, cell=cell, margin=margin)
    xml_path = os.path.join(dirpath, "DATA", "grid.xml")
    db_path = os.path.join(dirpath, "DATA", "grid.db")
    os.makedirs(os.path.dirname(xml_path), exist_ok=True)
    with open(xml_path, "w") as f:
        f.write(f"""<?xml version="1.0"?>
<MeteoGrid>
  <gridstructure isregular="true" isutm="true" istin="false"
                 isfixedfields="false">
    <header>
      <xll>{xll!r}</xll>
      <yll>{yll!r}</yll>
      <nrrows>{n_cells}</nrrows>
      <nrcols>{n_cells}</nrcols>
      <xwidth>{cell!r}</xwidth>
      <ywidth>{cell!r}</ywidth>
    </header>
  </gridstructure>
  <tablehourly>
    <fieldtime>PragaTime</fieldtime>
    <prefix></prefix>
    <postfix>_H</postfix>
  </tablehourly>
</MeteoGrid>
""")
    if os.path.exists(db_path):
        os.remove(db_path)

    rng = np.random.default_rng(seed)
    pots = _site_clear_sky(PROJECT_DATE)
    date = datetime.datetime(*PROJECT_DATE)
    times = [(date + datetime.timedelta(hours=h)).strftime("%Y-%m-%d %H:%M")
             for h in range(24)]
    codes = {"t": HOURLY_DB_IDS[MeteoVariable.AIR_TEMPERATURE],
             "prec": HOURLY_DB_IDS[MeteoVariable.PRECIPITATION],
             "rh": HOURLY_DB_IDS[MeteoVariable.AIR_REL_HUMIDITY],
             "wind": HOURLY_DB_IDS[MeteoVariable.WIND_SCALAR_INTENSITY],
             "rad": HOURLY_DB_IDS[MeteoVariable.GLOBAL_IRRADIANCE]}
    con = sqlite3.connect(db_path)
    con.execute("CREATE TABLE CellsProperties (Code TEXT NOT NULL PRIMARY KEY, "
                "Name TEXT, Row INTEGER, Col INTEGER, Height REAL, Active INTEGER)")
    for row, col, _, _, z in cells:
        code = f"{row:03d}{col:03d}"
        con.execute("INSERT INTO CellsProperties VALUES (?,?,?,?,?,?)",
                    (code, f"cell {row} {col}", row, col, z, 1))
        table = f"{code}_H"
        con.execute(f'CREATE TABLE "{table}" (PragaTime TEXT, VariableCode '
                    "INTEGER, Value REAL, PRIMARY KEY (PragaTime, VariableCode))")
        rows = []
        for hour in range(24):
            w = _station_weather(rng, hour, z, pots[hour])
            rows += [(times[hour], codes[k], float(w[k])) for k in codes]
        con.executemany(f'INSERT INTO "{table}" VALUES (?,?,?)', rows)
    con.commit()
    con.close()
    return xml_path, db_path


# ----------------------------------------------------------------------
# the side process models: HYDRALL and RothC in the model cycle
# ----------------------------------------------------------------------

# MODEL_CONFIG with the forest model and the soil carbon model
HYDRALL_CONFIG = dict(MODEL_CONFIG, compute_hydrall=True, compute_rothc=True)


def forest_mask(dem, seed: int) -> np.ndarray:
    """A seeded forest over part of the catchment: the valid cells of the
    union of three discs with seeded centres (inside the catchment's
    middle half) and radii (0.08-0.18 of the box side)."""
    n_r, n_c = dem.shape
    rng = np.random.default_rng(seed + 1)
    rows, cols = np.mgrid[0:n_r, 0:n_c]
    mask = np.zeros(dem.shape, dtype=bool)
    for _ in range(3):
        r0, c0 = rng.uniform(0.25, 0.75, 2) * (n_r, n_c)
        rad = rng.uniform(0.08, 0.18) * max(n_r, n_c)
        mask |= (rows - r0) ** 2 + (cols - c0) ** 2 <= rad ** 2
    return mask & ~np.isclose(dem, -9999.0)


def build_hydrall_problem(dem, cell, params, device, *,
                          seed: int = 0) -> Criteria3DModel:
    """:func:`build_model_problem` with :data:`HYDRALL_CONFIG` and the
    :func:`forest_mask` of ``seed`` as the model's forest."""
    model = build_model_problem(dem, cell, params, device,
                                ModelConfig(**HYDRALL_CONFIG))
    model.forest_mask = torch.tensor(forest_mask(dem, seed),
                                     device=model.grid.device)
    return model


def small_hydrall_model(params: SolverParameters, device, n: int = 16,
                        seed: int = 0) -> Criteria3DModel:
    """:func:`build_hydrall_problem` on the synthetic catchment cut to an
    n x n box, for the card against the CPU."""
    dem = synthetic_catchment(seed, n=n, radius=n * 366.0 / 768)
    return build_hydrall_problem(dem, 4.0, params, device, seed=seed)


# ----------------------------------------------------------------------
# a VINE3D project on disk
# ----------------------------------------------------------------------

# the vine project's day: midsummer (local time, UTC+1)
VINE_DATE = (2023, 6, 21)
# a mid-season canopy past bud burst (the state the JAX package's month
# run starts from, tests/test_vine3d.py): set on a dormant GrapevineState
VINE_CANOPY = dict(chilling=160.0, force_bud_burst=1e4, force_veg=20.0,
                   stage=3.2, lai=1.0, shoot_leaf_number=8.0)
# field id -> (landuse, cultivar, training system, max grass LAI,
# irrigation max rate [mm/h]); field 1 the meadow's west half, 5 its east
# half, 4 the forest patch of write_project's land-use map
VINE_FIELDS = {1: ("VINEYARD", 2, 1, 1.2, 4.0),
               4: ("FOREST", 1, 1, 0.5, 0.0),
               5: ("VINEYARD_NEW", 1, 2, 1.0, 0.0)}
# the VINE_DATE field book: 2 h of irrigation on field 1, trimming and
# leaf removal on field 5 (checked at hour 1); harvest, thinning and a
# tartaric-acid analysis in September
VINE_IRRIGATION_HOURS = 2


def seed_vine_canopy(model) -> None:
    """Set :data:`VINE_CANOPY` on every cell of a port ``Vine3DModel``."""
    v = model.vine
    model.vine = dataclasses.replace(v, **{
        k: torch.full_like(getattr(v, k), val) for k, val in VINE_CANOPY.items()})


def _summer_weather(rng, hour: int, z: float, pot: float) -> dict:
    """One station's readings at ``hour`` of :data:`VINE_DATE` at altitude
    ``z`` [m]: 17-31 degC (6.5 K/km), a shower of 4 mm/h at 16-17 h,
    humid nights and mornings (leaf wetness), a dry afternoon."""
    t = 24.0 + 7.0 * np.sin((hour - 9.0) / 24.0 * 2.0 * np.pi) \
        - 0.0065 * (z - 200.0)
    prec = 4.0 if hour in (16, 17) else 0.0
    wet = prec > 0.0
    rh = 90.0 if wet else 60.0 - 25.0 * np.sin((hour - 9.0) / 24.0 * 2.0 * np.pi)
    return {
        "t": t + rng.normal(0.0, 0.15),
        "prec": max(prec * (1.0 + 0.1 * rng.normal()), 0.0),
        "rh": float(np.clip(rh + rng.normal(0.0, 2.0), 25.0, 100.0)),
        "wind": 2.0 + rng.uniform(-0.5, 0.5),
        "rad": max(pot * (0.3 if wet else 0.75) * (1.0 + 0.05 * rng.normal()), 0.0),
    }


def _write_vine_db(path: str) -> None:
    """The VINE3D fields DB: ``cultivar`` (every column the loaders read,
    two cultivars), ``training_system`` (two), ``fields``
    (:data:`VINE_FIELDS`) and ``field_book``."""
    import sqlite3
    cultivar_cols = (
        "id_cultivar", "name", "phenovitis_force_physiological_maturity",
        "miglietta_d", "miglietta_f", "miglietta_fruit_biomass_offset",
        "miglietta_fruit_biomass_slope", "phenovitis_ecodormancy",
        "phenovitis_critical_chilling", "phenovitis_force_flowering",
        "phenovitis_force_veraison", "phenovitis_force_fruitset",
        "degree_days_veraison", "hydrall_stress_threshold", "hydrall_vpd",
        "hydrall_alpha_leuning", "hydrall_carbox_rate")
    cultivars = [
        (1, "sangiovese", 95.71, 0.0018, 1.34, 0.25, 0.01, 176.26, 78.69,
         24.71, 75.86, 34.71, 2547.0, 0.4, 1300.0, 10.0, 115.0),
        (2, "nebbiolo", 106.5, 0.0021, 1.31, 0.22, 0.012, 140.0, 81.3,
         26.2, 79.4, 36.9, 2734.0, 0.35, 1200.0, 9.0, 108.0)]
    con = sqlite3.connect(path)
    con.execute("CREATE TABLE cultivar (" + ", ".join(
        f"{c} {'TEXT' if c == 'name' else 'REAL'}" for c in cultivar_cols) + ")")
    con.executemany(f"INSERT INTO cultivar VALUES ({','.join('?' * len(cultivar_cols))})",
                    cultivars)
    con.execute("CREATE TABLE training_system (id_training_system INTEGER, "
                "name TEXT, nr_shoots_plant REAL, row_width REAL, "
                "row_height REAL, row_distance REAL, plant_distance REAL)")
    con.executemany("INSERT INTO training_system VALUES (?,?,?,?,?,?,?)", [
        (1, "guyot", 9.1, 0.4, 1.6, 2.5, 0.9),
        (2, "cordon", 12.0, 0.5, 1.4, 2.8, 1.0)])
    con.execute("CREATE TABLE fields (id_field INTEGER, landuse TEXT, "
                "id_cultivar INTEGER, id_training_system INTEGER, "
                "max_lai_grass REAL, irrigation_max_rate REAL)")
    con.executemany("INSERT INTO fields VALUES (?,?,?,?,?,?)",
                    [(fid,) + row for fid, row in VINE_FIELDS.items()])
    con.execute("CREATE TABLE field_book (date_ TEXT, id_field INTEGER, "
                "irrigated INTEGER, grass INTEGER, pinchout INTEGER, "
                "leaf_removal INTEGER, harvesting_performed INTEGER, "
                "cluster_thinning INTEGER, tartaric_acid REAL, "
                "irrigation_hours REAL, thinning_percentage REAL)")
    day = "%04d-%02d-%02d" % VINE_DATE
    con.executemany("INSERT INTO field_book VALUES (?,?,?,?,?,?,?,?,?,?,?)", [
        (day, 1, 1, 0, 0, 0, 0, 0, None, float(VINE_IRRIGATION_HOURS), None),
        (day, 5, 0, 1, 1, 1, 0, 0, None, None, None),
        ("2023-09-12", 1, 0, 0, 0, 0, 0, 1, None, None, 30.0),
        ("2023-09-20", 1, 0, 0, 0, 0, 1, 0, 5.8, None, None),
        ("2023-09-20", 5, 0, 2, 0, 0, 1, 0, None, None, None)])
    con.commit()
    con.close()


def write_vine_project(dirpath: str, *, n: int, seed: int,
                       n_stations: int = 6) -> str:
    """Write a synthetic VINE3D project under ``dirpath`` (numpy and
    sqlite3 only, so that both packages load the same files) on top of
    :func:`write_project`; returns the path of its ini.

    - the land-use map carries the field ids: the meadow's west half is
      field 1 (VINEYARD), its east half field 5 (VINEYARD_NEW, also a land
      unit in DATA/crop.db), the forest patch field 4 (not a vineyard); the
      URBAN strip and the ROAD line are no field;
    - DATA/vine.db (:func:`_write_vine_db`): two cultivars and two training
      systems, the fields, and a field book with irrigation on
      :data:`VINE_DATE`, trimming and leaf removal, a cluster thinning, a
      harvest and a tartaric-acid analysis;
    - DATA/meteo.db holds ``n_stations`` stations reporting the 24 hours of
      :data:`VINE_DATE` (:func:`_summer_weather`);
    - the ini names ``vine3d_db`` under [project] and ``compute_diseases``
      under [settings].
    """
    import os
    import sqlite3

    from criteria3d_tpu_torch.io.esri import read_flt, write_flt

    ini = write_project(dirpath, n=n, seed=seed, n_stations=n_stations)
    data = os.path.join(dirpath, "DATA")
    land, hdr = read_flt(os.path.join(dirpath, "MAPS", "landuse"))
    cols = np.mgrid[0:n, 0:n][1]
    land = np.where((land == 1.0) & (cols >= n // 2), 5.0, land)
    write_flt(os.path.join(dirpath, "MAPS", "landuse"), land, hdr)
    con = sqlite3.connect(os.path.join(data, "crop.db"))
    con.execute("INSERT INTO land_units VALUES (?,?,?,?,?,?)",
                (5, "young vineyard", "HERBACEOUS", "GRASS", 0.2, 0.002))
    con.commit()
    con.close()
    _write_vine_db(os.path.join(data, "vine.db"))

    os.remove(os.path.join(data, "meteo.db"))
    from criteria3d_tpu_torch.core.geo import latlon_to_utm
    zone = latlon_to_utm(*PROJECT_SITE, 32)[2]
    _write_stations(os.path.join(data, "meteo.db"), hdr, zone, n_stations,
                    np.random.default_rng(seed + 100), VINE_DATE,
                    _summer_weather)

    with open(ini) as f:
        text = f.read()
    text = text.replace("[project]\n", "[project]\nvine3d_db = DATA/vine.db\n", 1)
    text = text.replace("[settings]\n", "[settings]\ncompute_diseases = true\n", 1)
    with open(ini, "w") as f:
        f.write(text)
    return ini

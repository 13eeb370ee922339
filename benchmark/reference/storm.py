"""A cell's period run by the plain reference: the grid and the initial
inputs worked out again from the DEM the benchmark hands it, then the
host-looped water or coupled period of 988b1ed; and the water a field of
heads holds on the grid the period ran on, which :func:`run_period` hands
back (:func:`storage_of`): it judges the storage a run reports against the
heads it hands back.

``lowered=True`` runs the control: the float64 accumulations in float32
(:mod:`benchmark.reference.precision`).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from benchmark.reference import precision
from benchmark.reference.core.grid import BoundaryType, Grid
from benchmark.reference.core.soil import SoilFields
from benchmark.reference.core.state import SolverParameters, WaterState
from benchmark.reference.solver import coupled as C
from benchmark.reference.solver import heat as H
from benchmark.reference.solver import water as W
from benchmark.reference.solver.step import (compute_period_stats,
                                             initialize_balance)


def catchment_grid(config: dict, dem, device) -> Grid:
    """The cell's grid on ``device``, from the DEM."""
    return Grid.build(dem, float(config["cell_m"]),
                      SoilFields.uniform(dem.shape, device=device, **config["soil"]),
                      total_depth=config["total_depth_m"],
                      min_thickness=config["min_thickness_m"],
                      max_thickness=config["max_thickness_m"],
                      max_thickness_depth=config["max_thickness_depth_m"], device=device)


def storm_inputs(config: dict, traffic: dict, dem, device, params: SolverParameters):
    """The cell's grid and initial inputs: ``(grid, water)`` or, with soil
    heat, ``(grid, water, heat, boundary)``."""
    grid = catchment_grid(config, dem, device)
    water = WaterState.initialize(grid, params, matric_potential=float(traffic["psi0_m"]),
                                  device=grid.device)
    water = initialize_balance(grid, params, water)
    sink = torch.zeros_like(water.sink_source)
    rain = float(traffic["rain_m_per_h"])
    sink[0] = torch.where(grid.mask[0],
                          torch.full_like(sink[0], rain * float(grid.area) / 3600.0), 0.0)
    water = dataclasses.replace(water, sink_source=sink)
    heat = config.get("heat")
    if not heat:
        return grid, water
    # every valid layer-1 node an atmospheric HeatSurface node
    btype, bsize = grid.btype.clone(), grid.bsize.clone()
    btype[1] = torch.where(grid.mask[1], int(BoundaryType.HEAT_SURFACE), btype[1])
    bsize[1] = torch.where(grid.mask[1], torch.full_like(bsize[1], float(grid.area)),
                           bsize[1])
    grid = dataclasses.replace(grid, btype=btype, bsize=bsize)
    heat_state = H.initialize_heat(grid, float(heat["t0_K"]))
    storage = H.heat_storage(grid, params, heat_state, water)
    heat_state = dataclasses.replace(heat_state, storage_prev=storage, storage_whole=storage)
    boundary = H.HeatBoundary.uniform(
        grid.shape[1:], mask=grid.btype[1] == int(BoundaryType.HEAT_SURFACE),
        device=grid.device, air_temperature=float(heat["air_temperature_K"]),
        rel_humidity=float(heat["rel_humidity_pct"]), wind_speed=float(heat["wind_speed_m_s"]),
        net_irradiance=float(heat["net_irradiance_W_m2"]))
    return grid, water, heat_state, boundary


def reference_params(config: dict) -> SolverParameters:
    """The configuration's solver parameters in the reference."""
    if config["preset"] != "fast_f32":
        raise ValueError(f"unknown preset {config['preset']!r}")
    heat = config.get("heat") or {}
    return SolverParameters.fast_f32(heat_vapor=bool(heat.get("vapor")),
                                     heat_frozen_props=bool(heat.get("frozen_props")))


def storage_of(config: dict, grid: Grid, h: torch.Tensor) -> float:
    """The water [m3] that the total heads ``h`` (a float64 (L, R, C) field
    of the cell's catchment) hold on ``grid``, the grid a period of the
    cell ran on (``run_period``'s ``"grid"``), as the float32 psi-carry
    step counts its storage: the signed psi in float32, its saturation,
    theta x volume in the soil and the ponded depth x area on the surface,
    summed in float64, on ``grid``'s device. The count reads the grid's
    mask, elevations, volumes and soil, which the heat surface's boundary
    types leave as they are."""
    params = reference_params(config)
    psi = torch.where(grid.mask, h.to(grid.device) - grid.z, 0.0).to(params.sweep_dtype)
    se = W.compute_se_psi(grid, params, psi)
    surf, soil, _ = W.mass_balance_sums_psi(grid, params, psi, se, torch.zeros_like(psi))
    return float((surf + soil).to(params.dtype))


def run_period(config: dict, traffic: dict, dem, device, lowered: bool = False) -> dict:
    """The cell's period from its initial inputs on ``device``: the heads,
    the saturation, the water storage it reports and the whole-period
    water MBR on the CPU, the solver's counts, the grid it ran on (on
    ``device``, for :func:`storage_of`) and, with soil heat, the
    temperatures and the period's boundary heat sink. ``lowered``: the
    control."""
    with precision.lowered() if lowered else contextlib.nullcontext():
        return _run(config, traffic, dem, torch.device(device))


def _run(config: dict, traffic: dict, dem, device) -> dict:
    params = reference_params(config)
    inputs = storm_inputs(config, traffic, dem, device, params)
    period = float(traffic["period_s"])
    if len(inputs) == 4:
        C.reset_counts()
        water, heat_state = C.compute_period_coupled(inputs[0], params, *inputs[1:], period)
        cnt = C.counts()
        stats = [cnt["steps"], cnt["attempts"], cnt["approximations"],
                 cnt["inner_iterations"]]
    else:
        water, stats = compute_period_stats(inputs[0], params, inputs[1], period)
        heat_state = None
    out = dict(h=water.h.to("cpu", torch.float64), se=water.se.to("cpu", torch.float64),
               storage=float(water.balance_current.storage),
               mbr=float(water.balance_whole.mbr), stats=list(stats),
               mask=inputs[0].mask.to("cpu"), grid=inputs[0])
    if heat_state is not None:
        out.update(t=heat_state.t.to("cpu", torch.float64),
                   heat_sink=float(heat_state.sink_whole),
                   heat_sweeps=cnt["heat_sweeps"])
    return out

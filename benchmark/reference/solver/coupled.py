"""Coupled water + heat stepping.

The port's eager, host-looped coupled step (computeStep's heat
sub-stepping, soilFluxes3D.cpp:1785-1821, and CPUSolver::run,
cpusolver.cpp:77-91) on the path the cells run: heat with vapor and
chunk-frozen properties (``heat_vapor``, ``heat_frozen_props``) on one
whole box. Each accepted water step of length dtWater is covered by
boundary chunks, each with its boundary heat flux and Courant limit
evaluated once (updateBoundaryHeatData, heat.cpp:237-341), and each chunk
by heat sub-steps halved while the heat balance fails (|heatMBR| > 1).

The three nested loops (water steps, chunks capped at ``max_substeps``,
sub-steps capped at 4096) are host loops; their bookkeeping (t_sum, chunk,
dt_try, the halving) runs on the host in float64. The host reads one
Courant maximum per chunk, one MBR per sub-step and one norm per heat
sweep, besides the water solver's reads. The counts of a run are in
:func:`counts` (reset them with :func:`reset_counts`).
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark.reference.core.grid import Grid
from benchmark.reference.core.state import (BalanceData, SolverParameters,
                                             WaterState)
from benchmark.reference.device import host_read
from benchmark.reference.solver import heat as H
from benchmark.reference.solver.step import _compute_step
from benchmark.reference.solver.water import _set0

__all__ = ["compute_period_coupled", "counts", "reset_counts"]

# solver effort of the coupled steps since the last reset_counts()
_COUNT_NAMES = ("steps", "attempts", "approximations", "inner_iterations",
                "chunks", "substeps_accepted", "substeps_rejected")
_COUNTS = dict.fromkeys(_COUNT_NAMES, 0)


def reset_counts() -> None:
    """Set the coupled step's counts and the heat sweep count to 0."""
    _COUNTS.update(dict.fromkeys(_COUNT_NAMES, 0))
    H.heat_jacobi_solve.sweeps = 0


def counts() -> dict:
    """Water steps, attempts, approximations and inner iterations; heat
    chunks, accepted and rejected sub-steps and heat sweeps, since the
    last :func:`reset_counts`."""
    return dict(_COUNTS, heat_sweeps=H.heat_jacobi_solve.sweeps)


def _with_t(heat: H.HeatState, t, storage_prev, sink_whole, mbr):
    # t_old equals t throughout these loops (every accepted sub-step sets
    # both from the same value)
    return dataclasses.replace(heat, t=t, t_old=t, storage_prev=storage_prev,
                               sink_whole=sink_whole, mbr=mbr)


def _compute_step_coupled(grid: Grid, params: SolverParameters,
                          water: WaterState, heat_state: H.HeatState,
                          boundary: H.HeatBoundary, max_time_step: float,
                          dt_curr: float, max_substeps: int):
    """One adaptive water step with the heat hooks, then its heat
    sub-steps; ``dt_curr`` is the water step size on the host. Returns
    ``(water, heat, dt_water, dt_curr)``."""
    if not (params.heat_frozen_props and params.heat_vapor):
        raise ValueError("the reference runs heat with vapor and chunk-frozen properties")
    sd = params.sweep_dtype
    # the thermal water flux is a constant of the water step, from the
    # step-start (psi, k) and temperatures
    tw_frozen = H.thermal_water_flux(grid, params, heat_state,
                                     (water.h - grid.z).to(sd), water.k.to(sd))

    def thermal_flux(psi, k):
        return tw_frozen

    # conductances frozen once per computeStep from the start-of-step
    # state (updateConductance, heat.cpp:214-236)
    conduct = H.surface_conductances(grid, params, heat_state, boundary, water.h)

    # the HeatSurface evaporative water boundary, per Picard iteration
    # (water.cpp:708-747)
    def evap_flux(psi, dt):
        return H.heat_surface_water_sink(grid, params, heat_state, boundary, psi, dt,
                                         conductances=conduct)

    water_new, dt_water, (n_att, n_app, n_it), boundary_rate, dt_curr = \
        _compute_step(grid, params, water, max_time_step, dt_curr,
                      extra_flux_fn=thermal_flux, boundary_flux_fn=evap_flux)
    _COUNTS["steps"] += 1
    _COUNTS["attempts"] += n_att
    _COUNTS["approximations"] += n_app
    _COUNTS["inner_iterations"] += n_it
    # the heat boundary's latent flux reads the evaporative water rate of
    # the water step's last assembly (heat.cpp:957-966)
    evap_rate = boundary_rate[1]

    # --- outer loop over boundary chunks (soilFluxes3D.cpp:1805-1818) ---
    heat_mask = _set0(grid.mask, False)
    t_f = heat_state.t
    sp, sw, mbr = (heat_state.storage_prev, heat_state.sink_whole,
                   heat_state.mbr)
    t_sum, dt_pref, it = 0.0, dt_water, 0
    while t_sum < dt_water and it < max_substeps:
        chunk_max = min(dt_pref, dt_water - t_sum)
        flow, chunk, _ = H.update_boundary_heat(
            grid, params, _with_t(heat_state, t_f, sp, sw, mbr), boundary,
            water_new, chunk_max, dt_water, conductances=conduct,
            evap_rate=evap_rate)
        # the chunk's frozen boundary flow sum (the sink side of every
        # sub-step balance)
        flow_sum = H._masked_sum(heat_mask, flow)
        cache = H.energy_invariants(grid, params, water_new, chunk, dt_water)
        # the frozen factors are dt-independent: one property assembly per
        # chunk
        fzsys = H.chunk_frozen_system(grid, params, t_f, water_new, chunk, dt_water,
                                      flow, flow_sum, cache)
        _COUNTS["chunks"] += 1

        # --- inner loop over sub-steps (CPUSolver::run, cpusolver.cpp:77-91):
        # halve on |heatMBR| > 1 until accepted, always covering the chunk
        t_in, dt_h, it_in = 0.0, chunk, 0
        while t_in < chunk and it_in < 4096:
            dt_try = min(dt_h, chunk - t_in)
            t_f, sp, sw, mbr, ok = H.heat_substep_frozen(
                grid, params, fzsys, t_f, sp, sw, dt_try)
            if ok:
                t_in += dt_try
                _COUNTS["substeps_accepted"] += 1
            else:
                dt_h = dt_try * 0.5
                _COUNTS["substeps_rejected"] += 1
            it_in += 1
        t_sum, dt_pref, it = t_sum + chunk, chunk, it + 1

    return water_new, _with_t(heat_state, t_f, sp, sw, mbr), dt_water, dt_curr


def compute_period_coupled(grid: Grid, params: SolverParameters,
                           water: WaterState, heat_state: H.HeatState,
                           boundary: H.HeatBoundary, period,
                           max_substeps: int = 256):
    """Advance coupled water + heat over a whole period (computePeriod with
    computeHeat active, soilFluxes3D.cpp:1760-1821); returns ``(water,
    heat)``, the period water balance closed (water.cpp:143-156)."""
    period = float(period)

    # reset the period sink/source counter (soilFluxes3D.cpp:1764)
    bp = water.balance_period
    water = dataclasses.replace(water, balance_period=BalanceData(
        bp.storage, torch.zeros_like(bp.sink_source), bp.mbe, bp.mbr))

    dt_curr = host_read(water.dt_curr)
    t = 0.0
    while t < period:
        water, heat_state, dt, dt_curr = _compute_step_coupled(
            grid, params, water, heat_state, boundary, period - t, dt_curr,
            max_substeps)
        t = t + dt

    cur, per, whole = (water.balance_current, water.balance_period,
                       water.balance_whole)
    whole_sink = whole.sink_source + per.sink_source
    d_period = cur.storage - per.storage
    d_whole = cur.storage - whole.storage
    per_mbe = d_period - per.sink_source
    whole_mbe = d_whole - whole_sink
    # the coupled period keeps the reference's signed sink here, unlike
    # compute_period_stats' |sink| (DEVIATIONS #30): reproduced as written
    ref = torch.clamp_min(whole_sink, 0.001)
    whole_mbr = whole_mbe / ref

    water = dataclasses.replace(
        water,
        balance_period=BalanceData(cur.storage, per.sink_source, per_mbe,
                                   per.mbr),
        balance_whole=BalanceData(whole.storage, whole_sink, whole_mbe,
                                  whole_mbr))
    return water, heat_state

"""Coupled water + heat stepping.

PyTorch counterpart of ``criteria3d_tpu/solver/coupled.py`` (computeStep's
heat sub-stepping, soilFluxes3D.cpp:1785-1821, and CPUSolver::run,
cpusolver.cpp:77-91): each accepted water step of length dtWater is covered
by boundary chunks, each with its boundary heat flux and Courant limit
evaluated once (updateBoundaryHeatData, heat.cpp:237-341), and each chunk by
heat sub-steps halved while the heat balance fails (|heatMBR| > 1).

The JAX package's three nested ``lax.while_loop``s (water steps, chunks
capped at ``max_substeps``, sub-steps capped at 4096) are host loops here;
their bookkeeping (t_sum, chunk, dt_try, the halving) runs on the host in
float64, the arithmetic JAX does. The water step runs its state machine
under the eager driver (solver/device_loop.py: the heat hooks stay
host-driven until their own slice), which hands the hooks ``dt`` as a 0-d
float64 tensor; the host reads the step's dt and counts once after it,
one Courant maximum per chunk, one MBR per sub-step and one norm per heat
sweep, besides the water machine's reads. The counts of a run are in :func:`counts` (reset them with
:func:`reset_counts`).

With ``params.mesh`` grid, water, heat and boundary are cut by
``shard_pytree`` and the whole coupled step runs on the mesh's blocks, as
JAX's GSPMD partitions it: the water step's heat hooks are per-block
closures over each block's tiles, the heat functions run per block with
their sums and maxima combined on ``mesh.home`` (solver/heat.py), and the
bookkeeping above stays on the host. ``gather_pytree`` joins the result.
"""

from __future__ import annotations

import dataclasses

import torch

from criteria3d_tpu_torch.core.grid import Grid
from criteria3d_tpu_torch.core.state import (BalanceData, SolverParameters,
                                             WaterState)
from criteria3d_tpu_torch.parallel.sharding import blocks_of, bmap
from criteria3d_tpu_torch.solver import heat as H
from criteria3d_tpu_torch.solver.step import _check_blocks, _compute_step, _is_fast
from criteria3d_tpu_torch.solver.water import _set0

__all__ = ["compute_step_coupled", "compute_period_coupled", "counts",
           "reset_counts"]

# solver effort of the coupled steps since the last reset_counts()
_COUNT_NAMES = ("steps", "attempts", "approximations", "inner_iterations",
                "chunks", "substeps_accepted", "substeps_rejected")


def reset_counts() -> None:
    """Set the coupled step's counts and the heat sweep count to 0."""
    compute_step_coupled.counts = dict.fromkeys(_COUNT_NAMES, 0)
    H.heat_jacobi_solve.sweeps = 0


def counts() -> dict:
    """Water steps, attempts, approximations and inner iterations; heat
    chunks, accepted and rejected sub-steps and heat sweeps, since the
    last :func:`reset_counts`."""
    return dict(compute_step_coupled.counts,
                heat_sweeps=H.heat_jacobi_solve.sweeps)


def _with_t(heat: H.HeatState, t, storage_prev, sink_whole, mbr):
    # t_old equals t throughout these loops (every accepted sub-step sets
    # both from the same value)
    return dataclasses.replace(heat, t=t, t_old=t, storage_prev=storage_prev,
                               sink_whole=sink_whole, mbr=mbr)


def _compute_step_coupled(grid: Grid, params: SolverParameters,
                          water: WaterState, heat_state: H.HeatState,
                          boundary: H.HeatBoundary, max_time_step: float,
                          max_substeps: int):
    """One adaptive water step with the heat hooks, then its heat
    sub-steps. Returns ``(water, heat, dt_water)``. On a mesh every hook is
    a Blocked of per-block closures, each over its block's tiles."""
    cnt = compute_step_coupled.counts
    frozen = params.heat_frozen_props and _is_fast(params)
    heat_b, boundary_b = blocks_of(heat_state), blocks_of(boundary)
    if frozen:
        # heat_frozen_props: the thermal water flux is a constant of the
        # water step, from the step-start (psi, k) and temperatures
        sd = params.sweep_dtype

        def thermal_hook(g, hs, h, k):
            tw_frozen = H.thermal_water_flux(g, params, hs, (h - g.z).to(sd),
                                             k.to(sd))
            return lambda psi, k: tw_frozen
        thermal_flux = bmap(thermal_hook, grid, heat_b, water.h, water.k)
    else:
        # re-evaluated at every Picard iteration from the current (psi, k)
        # iterate (computeLinkFluxes water.cpp:329-341, cpusolver.cpp:388);
        # it enters the RHS, not the balance
        def thermal_hook(g, hs):
            return lambda psi, k: H.thermal_water_flux(g, params, hs, psi, k)
        thermal_flux = bmap(thermal_hook, grid, heat_b)

    # conductances frozen once per computeStep from the start-of-step
    # state (updateConductance, heat.cpp:214-236)
    conduct = H.surface_conductances(grid, params, heat_state, boundary,
                                     water.h)

    # the HeatSurface evaporative water boundary, per Picard iteration
    # (water.cpp:708-747)
    evap_flux = None
    if params.heat_vapor:
        def evap_hook(g, hs, bd, cd):
            return lambda psi, dt: H.heat_surface_water_sink(
                g, params, hs, bd, psi, dt, conductances=cd)
        evap_flux = bmap(evap_hook, grid, heat_b, boundary_b, conduct)

    water_new, dt_water, (n_att, n_app, n_it), boundary_rate, _ = \
        _compute_step(grid, params, water, max_time_step,
                      extra_flux_fn=thermal_flux, boundary_flux_fn=evap_flux)
    cnt["steps"] += 1
    cnt["attempts"] += n_att
    cnt["approximations"] += n_app
    cnt["inner_iterations"] += n_it
    # the heat boundary's latent flux reads the evaporative water rate of
    # the water step's last assembly (heat.cpp:957-966)
    evap_rate = bmap(lambda r: r[1], boundary_rate) if params.heat_vapor else None

    # --- outer loop over boundary chunks (soilFluxes3D.cpp:1805-1818) ---
    heat_mask = bmap(lambda g: _set0(g.mask, False), grid)
    t_f = heat_state.t
    sp, sw, mbr = (heat_state.storage_prev, heat_state.sink_whole,
                   heat_state.mbr)
    t_sum, dt_pref, it = 0.0, dt_water, 0
    while t_sum < dt_water and it < max_substeps:
        chunk_max = min(dt_pref, dt_water - t_sum)
        with torch.profiler.record_function(H.HEAT_ASSEMBLE_RANGE):
            flow, chunk, _ = H.update_boundary_heat(
                grid, params, _with_t(heat_state, t_f, sp, sw, mbr), boundary,
                water_new, chunk_max, dt_water, conductances=conduct,
                evap_rate=evap_rate)
            # the chunk's frozen boundary flow sum (the sink side of every
            # sub-step balance)
            flow_sum = H._masked_sum(heat_mask, flow)
            cache = H.energy_invariants(grid, params, water_new, chunk, dt_water)
            cache_dt = chunk
            if frozen:
                # the frozen factors are dt-independent: one property
                # assembly per chunk
                fzsys = H.chunk_frozen_system(grid, params, t_f, water_new,
                                              chunk, dt_water, flow, flow_sum,
                                              cache)
        cnt["chunks"] += 1

        # --- inner loop over sub-steps (CPUSolver::run, cpusolver.cpp:77-91):
        # halve on |heatMBR| > 1 until accepted, always covering the chunk
        t_in, dt_h, it_in = 0.0, chunk, 0
        while t_in < chunk and it_in < 4096:
            dt_try = min(dt_h, chunk - t_in)
            if frozen:
                t_f, sp, sw, mbr, ok = H.heat_substep_frozen(
                    grid, params, fzsys, t_f, sp, sw, dt_try)
            else:
                if dt_try != cache_dt:
                    # the exact-mode energy cache is keyed on the sub-step
                    # length
                    with torch.profiler.record_function(H.HEAT_ASSEMBLE_RANGE):
                        cache = H.energy_invariants(grid, params, water_new,
                                                    dt_try, dt_water)
                new_heat, mbr_f = H.heat_step(
                    grid, params, _with_t(heat_state, t_f, sp, sw, mbr),
                    boundary, water_new, dt_try, dt_water,
                    conductances=conduct, evap_rate=evap_rate,
                    heat_flow=flow, energy_cache=cache, flow_sum=flow_sum)
                ok = abs(mbr_f) <= 1.0 or dt_try <= params.delta_t_min * 10.0
                t_f, sp, sw, mbr = (new_heat.t, new_heat.storage_prev,
                                    new_heat.sink_whole, new_heat.mbr)
                cache_dt = dt_try
            if ok:
                t_in += dt_try
                cnt["substeps_accepted"] += 1
            else:
                dt_h = dt_try * 0.5
                cnt["substeps_rejected"] += 1
            it_in += 1
        t_sum, dt_pref, it = t_sum + chunk, chunk, it + 1

    return water_new, _with_t(heat_state, t_f, sp, sw, mbr), dt_water


def compute_step_coupled(grid: Grid, params: SolverParameters,
                         water: WaterState, heat_state: H.HeatState,
                         boundary: H.HeatBoundary, max_time_step,
                         max_substeps: int = 256):
    """One adaptive water step followed by its heat sub-steps; returns
    ``(water', heat', dt_water)`` with ``dt_water`` a float.

    The water step runs with the heat hooks: the thermal water flux
    (RHS only) and, with ``heat_vapor``, the HeatSurface evaporative sink
    (RHS and balance). The heat sub-steps cover the whole water step.
    With ``params.mesh`` grid, water, heat and boundary are cut over it by
    ``shard_pytree`` and the result is blocked (join it with
    ``gather_pytree``); a mesh with whole inputs, blocked inputs without
    one, or a mix raise ``ValueError``."""
    _check_blocks(grid, params, water, heat_state, boundary)
    return _compute_step_coupled(grid, params, water, heat_state, boundary,
                                 float(max_time_step), max_substeps)


compute_step_coupled.counts = dict.fromkeys(_COUNT_NAMES, 0)


def compute_period_coupled(grid: Grid, params: SolverParameters,
                           water: WaterState, heat_state: H.HeatState,
                           boundary: H.HeatBoundary, period,
                           max_substeps: int = 256):
    """Advance coupled water + heat over a whole period (computePeriod with
    computeHeat active, soilFluxes3D.cpp:1760-1821); returns ``(water,
    heat)``, the period water balance closed as the JAX function closes
    it (water.cpp:143-156). On a mesh the inputs are blocked, as
    :func:`compute_step_coupled` takes them, and the period balance runs
    on the 0-d scalars on ``mesh.home``."""
    _check_blocks(grid, params, water, heat_state, boundary)
    period = float(period)

    # reset the period sink/source counter (soilFluxes3D.cpp:1764)
    bp = water.balance_period
    water = dataclasses.replace(water, balance_period=BalanceData(
        bp.storage, torch.zeros_like(bp.sink_source), bp.mbe, bp.mbr))

    t = 0.0
    while t < period:
        water, heat_state, dt = _compute_step_coupled(
            grid, params, water, heat_state, boundary, period - t, max_substeps)
        t = t + dt

    cur, per, whole = (water.balance_current, water.balance_period,
                       water.balance_whole)
    whole_sink = whole.sink_source + per.sink_source
    d_period = cur.storage - per.storage
    d_whole = cur.storage - whole.storage
    per_mbe = d_period - per.sink_source
    whole_mbe = d_whole - whole_sink
    # the JAX coupled period keeps the reference's signed sink here
    # (coupled.py:269), unlike compute_period_stats' |sink|
    # (DEVIATIONS #30): reproduced as written
    ref = torch.clamp_min(whole_sink, 0.001)
    whole_mbr = whole_mbe / ref

    water = dataclasses.replace(
        water,
        balance_period=BalanceData(cur.storage, per.sink_source, per_mbe,
                                   per.mbr),
        balance_whole=BalanceData(whole.storage, whole_sink, whole_mbe,
                                  whole_mbr))
    return water, heat_state

"""Adaptive time stepping: Picard outer loop, Jacobi inner loop, dt control.

PyTorch counterpart of the float32 psi-carry branches of
``criteria3d_tpu/solver/step.py`` (CPUSolver::waterMainLoop /
waterApproximationLoop / solveLinearSystem, cpusolver.cpp:143-468,672-703,
and evaluateWaterBalance, water.cpp:165-227).

The JAX package runs the nested loops (period -> step retry -> Picard ->
inner solve) on the device inside ``lax.while_loop``s. Here they are Python
loops: the fields stay on the device, and the host reads the few scalars
each decision needs through :func:`criteria3d_tpu_torch.device.host_read`
(the Courant number of each assembly, the norm of each sweep bundle, the MBR
of each balance, and the step size once per call). The scalar arithmetic of
those decisions runs on the host in float64, the type JAX uses for it; the
inner solver's convergence tests run in float32. Every select of the JAX
step is reproduced, including those applied whether or not the step was
accepted (best_h, dt_curr, courant, balance_current).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from criteria3d_tpu_torch.core.grid import Grid
from criteria3d_tpu_torch.core.state import (BalanceData, SolverParameters,
                                             WaterState)
from criteria3d_tpu_torch.device import host_read, scalar
from criteria3d_tpu_torch.solver import water as W
from criteria3d_tpu_torch.solver.jacobi_bundle import jacobi_solve_loop

__all__ = ["compute_step", "compute_period", "compute_period_stats",
           "initialize_balance", "check_supported"]

# step outcome codes (balanceResult_t, types.h:174)
RUNNING = 0
ACCEPTED = 1
REFUSED = 2
HALVED = 3
NAN = 4


def check_supported(params: SolverParameters) -> None:
    """Raise ``NotImplementedError`` for a configuration this port does not
    run yet, naming the ROADMAP.md item that brings it."""
    if params.sweep_dtype is None or params.sweep_dtype == params.dtype:
        raise NotImplementedError(
            "the float64 parity path (sweep_dtype=None: assemble_system + "
            "jacobi_sweep) is not ported yet; it is the next module slice "
            "(ROADMAP.md queue A, the f64 path)")
    if params.sweep_dtype != torch.float32:
        raise NotImplementedError(
            f"sweep_dtype={params.sweep_dtype}: only the float32 psi-carry "
            "path is ported")
    if params.inner_solver == "cg":
        raise NotImplementedError(
            "inner_solver='cg' (CG with the diagonal or vertical-line "
            "preconditioner, fast_f32()'s default) is not ported yet; it "
            "follows the f64 slice (ROADMAP.md queue A, CG)")
    if params.inner_solver != "jacobi":
        raise ValueError(f"unknown inner_solver {params.inner_solver!r}")
    if params.track_link_flow:
        raise NotImplementedError(
            "track_link_flow is not ported yet (ROADMAP.md queue A, link "
            "flows)")


def initialize_balance(grid: Grid, params: SolverParameters,
                       state: WaterState) -> WaterState:
    """Reset all balance counters to the current storage
    (initializeWaterBalance, water.cpp:35-65)."""
    se = W.compute_se(grid, params, state.h)
    storage = W.total_water_content(grid, params, state.h, se)
    zero = torch.zeros((), dtype=params.dtype, device=state.h.device)
    bal = BalanceData(storage=storage, sink_source=zero, mbe=zero, mbr=zero)
    return dataclasses.replace(
        state, h_old=state.h, best_h=state.h, se=se,
        boundary_flow_sum=torch.zeros_like(state.boundary_flow_sum),
        link_flow_sum=torch.zeros_like(state.link_flow_sum),
        balance_prev=bal, balance_current=bal,
        balance_period=bal, balance_whole=bal)


# ----------------------------------------------------------------------
# inner: Jacobi iterations
# ----------------------------------------------------------------------

def _jacobi_solve(system: W.LinearSystem, x0: torch.Tensor, grid: Grid,
                  params: SolverParameters, approx: int):
    """Iterate float32 psi-form Jacobi sweeps until convergence, divergence
    or the per-approximation cap max(25, (approx+1)*maxIter/maxApprox);
    returns ``(x, diverged, n_sweeps)``.

    ``use_pallas`` selects the bundled kernel (K sweeps per call, checked
    every K); otherwise one :func:`water.jacobi_sweep_psi` per check."""
    max_iter = params.max_iterations_for(approx)
    tol = max(params.residual_tolerance, 1e-7)

    if params.use_pallas:
        mask_f = grid.mask.to(params.sweep_dtype)
        return jacobi_solve_loop(system.b, system.c_up, system.c_down,
                                 system.c_lat, mask_f, x0, max_iter, tol,
                                 grid.n_nodes)

    tol32 = np.float32(tol)
    ten = np.float32(10.0)
    best = np.float32(1.0)
    x, it, done, diverged = x0, 0, False, False
    while not done and it < max_iter:
        x, norm = W.jacobi_sweep_psi(system, x, grid, grid.n_nodes)
        norm = np.float32(host_read(norm))
        converged = bool(norm < tol32)
        diverged = (not converged) and bool(norm > best * ten)
        best = np.minimum(best, norm)
        it += 1
        done = converged or diverged
    return x, diverged, it


def _decimal_floor_dt(dt: float) -> float:
    """Floor dt at its first significant decimal digit (checkCourant,
    cpusolver.cpp:262-277): multiply by 10 until >= 1, floor, scale back."""
    v, n = dt, 0
    while v < 1.0:
        v, n = v * 10.0, n + 1
    return float(np.floor(v)) / (10.0 ** n)


# ----------------------------------------------------------------------
# middle: Picard approximation loop
# ----------------------------------------------------------------------

@dataclasses.dataclass
class _ApproxCarry:
    """State of one step attempt; tensors on the device, scalars on the
    host (float64 for dt, Courant and MBR, as in JAX)."""

    approx: int
    result: int
    h: torch.Tensor            # float32 signed psi
    se: torch.Tensor
    k: torch.Tensor
    water_flow: torch.Tensor
    boundary_rate: torch.Tensor
    best_h: torch.Tensor
    best_mbr: float
    dt_curr: float
    courant: float
    balance: tuple             # (storage, sink, mbe, mbr) 0-d tensors
    n_sweeps: int


def _approximation_loop(grid: Grid, params: SolverParameters,
                        h: torch.Tensor, h_old: torch.Tensor,
                        se: torch.Tensor, sink_source: torch.Tensor,
                        pond: torch.Tensor, prev_storage: torch.Tensor,
                        dt: float, dt_curr: float) -> _ApproxCarry:
    """One attempt at time step ``dt`` (waterApproximationLoop,
    cpusolver.cpp:392-468), in float32 signed psi: ``h``/``h_old``/``se``
    are the psi-carry fields of the attempt's start."""
    psi_old32 = h_old
    zero = torch.zeros((), dtype=params.dtype, device=h.device)
    c = _ApproxCarry(
        approx=0, result=RUNNING, h=h, se=se, k=torch.zeros_like(h),
        water_flow=torch.zeros_like(h), boundary_rate=torch.zeros_like(h),
        best_h=h, best_mbr=math.inf, dt_curr=dt_curr, courant=0.0,
        balance=(zero, zero, zero, zero), n_sweeps=0)

    def evaluate():
        """evaluateWaterBalance (water.cpp:165-227) + accept/restore."""
        approx = c.approx
        storage, sink, mbe, mbr = W.current_mass_balance_psi(
            grid, params, c.h, c.se, c.water_flow, prev_storage, dt)
        err = abs(host_read(mbr))
        is_nan = not math.isfinite(err)
        can_halve = dt > params.delta_t_min
        ok = (not is_nan) and err < params.mbr_threshold

        # best-step tracking (before the instability check)
        if (not is_nan) and (not ok) and (approx == 0 or err < c.best_mbr):
            c.best_h, c.best_mbr = c.h, err

        unstable = (not is_nan) and (not ok) and (
            err > c.best_mbr * params.instability_factor
            or approx == params.max_approximations - 1)
        halved = (is_nan and can_halve) or (unstable and can_halve)
        restore = ((is_nan and not can_halve and approx > 0)
                   or (unstable and not can_halve))
        fatal_nan = is_nan and not can_halve and approx == 0
        accepted = ok or restore
        # a refused balance keeps the Picard loop RUNNING
        result = (ACCEPTED if accepted else HALVED if halved
                  else NAN if fatal_nan else RUNNING)

        grow = (ok and approx < 3 and err < params.mbr_threshold * 0.1
                and c.courant < params.courant_threshold)
        if halved:
            dt_new = max(c.dt_curr * 0.5, params.delta_t_min)
        elif grow:
            dt_new = min(params.delta_t_max, c.dt_curr * 2.0)
        else:
            dt_new = c.dt_curr

        if restore:
            # restoreBestStep (water.cpp:253-267): the fused assembly
            # recomputes flows and k for the restored iterate
            h_r = c.best_h
            se_r = W.compute_se_psi(grid, params, h_r)
            _, flow_r, rate_r, k_r = W.assemble_fast(
                grid, params, h_r, psi_old32, se_r, sink_source, pond,
                approx, dt)
            c.balance = W.current_mass_balance_psi(
                grid, params, h_r, se_r, flow_r, prev_storage, dt)
            c.h, c.se, c.k, c.water_flow, c.boundary_rate = (
                h_r, se_r, k_r, flow_r, rate_r)
        else:
            c.balance = (storage, sink, mbe, mbr)
        c.result, c.dt_curr = result, dt_new

    while c.result == RUNNING and c.approx < params.max_approximations:
        approx = c.approx
        system, flow, rate, k = W.assemble_fast(
            grid, params, c.h, psi_old32, c.se, sink_source, pond, approx, dt)
        courant = host_read(system.courant)

        if courant >= 1.01 and dt > params.delta_t_min:
            # checkCourant (cpusolver.cpp:248-281)
            dt_new = _decimal_floor_dt(c.dt_curr / courant)
            c.result, c.dt_curr = HALVED, max(params.delta_t_min, dt_new)
            c.courant, c.k, c.water_flow, c.boundary_rate = courant, k, flow, rate
            c.approx = approx + 1
            continue

        x, diverged, n_it = _jacobi_solve(system, c.h, grid, params, approx)
        c.n_sweeps += n_it
        if diverged and dt > params.delta_t_min:
            c.result = HALVED
            c.dt_curr = max(params.delta_t_min, c.dt_curr / 2.0)
            c.courant, c.k, c.water_flow, c.boundary_rate = courant, k, flow, rate
            c.approx = approx + 1
            continue

        c.h, c.se = x, W.compute_se_psi(grid, params, x)
        c.k, c.water_flow, c.boundary_rate, c.courant = k, flow, rate, courant
        evaluate()
        c.approx = approx + 1
    return c


# ----------------------------------------------------------------------
# outer: step-retry loop (waterMainLoop) and the public API
# ----------------------------------------------------------------------

def _compute_step(grid: Grid, params: SolverParameters, state: WaterState,
                  max_time_step: float, dt_curr: float):
    """Retry attempts until one is accepted (or fails fatally).

    ``dt_curr`` is ``state.dt_curr`` already on the host. Returns
    ``(state, dt_accepted, (n_attempts, n_approx, n_sweeps),
    boundary_rate, dt_curr)`` with the host copy of the new step size."""
    dtype = params.dtype
    sd = params.sweep_dtype
    mask, z = grid.mask, grid.z
    st = state
    n_att = n_app = n_sw = 0
    while True:
        dt = min(dt_curr, max_time_step)
        h_old = st.h
        # psi-carry: ONE f64 subtraction per attempt, then the whole Picard
        # loop runs in f32 signed psi
        psi_seed = torch.where(mask, st.h - z, 0.0).to(sd)
        se_seed = W.compute_se_psi(grid, params, psi_seed)
        out = _approximation_loop(
            grid, params, psi_seed, psi_seed, se_seed, st.sink_source,
            st.pond, st.balance_prev.storage, dt, dt_curr)

        accepted = out.result == ACCEPTED
        # NAN is fatal; a RUNNING leak is treated as fatal too
        fatal = out.result in (NAN, RUNNING)
        storage, sink, mbe, mbr = out.balance

        # best_h is taken whether or not the attempt was accepted
        best_acc = torch.where(mask, z + out.best_h.to(dtype), 0.0)
        if accepted:
            # acceptStep (water.cpp:230-251); reconstruct the f64 state
            bp, per = st.balance_prev, st.balance_period
            changes = dict(
                h=torch.where(mask, z + out.h.to(dtype), 0.0),
                h_old=h_old,
                se=out.se.to(dtype),
                k=out.k.to(dtype),
                boundary_flow_sum=(st.boundary_flow_sum
                                   + out.boundary_rate.to(dtype) * dt),
                balance_prev=BalanceData(storage, sink, bp.mbe, bp.mbr),
                balance_period=BalanceData(per.storage,
                                           per.sink_source + sink,
                                           per.mbe, per.mbr))
        else:
            changes = {}
        st = dataclasses.replace(
            st, best_h=best_acc,
            dt_curr=scalar(out.dt_curr, dtype, st.dt_curr.device),
            courant=scalar(out.courant, dtype, st.courant.device),
            balance_current=BalanceData(storage, sink, mbe, mbr),
            **changes)
        dt_curr = out.dt_curr
        n_att, n_app, n_sw = n_att + 1, n_app + out.approx, n_sw + out.n_sweeps
        if accepted or fatal:
            return (st, dt, (n_att, n_app, n_sw),
                    out.boundary_rate.to(dtype), dt_curr)


def compute_step(grid: Grid, params: SolverParameters, state: WaterState,
                 max_time_step: float):
    """Advance the water state by one adaptive step (<= max_time_step [s]);
    returns ``(new_state, dt_accepted)`` with ``dt_accepted`` a float
    (computeStep, soilFluxes3D.cpp:1785-1821)."""
    check_supported(params)
    st, dt, _, _, _ = _compute_step(grid, params, state, float(max_time_step),
                                    host_read(state.dt_curr))
    return st, dt


def compute_period_stats(grid: Grid, params: SolverParameters,
                         state: WaterState, period_seconds,
                         start_seconds=0.0):
    """Like :func:`compute_period` but also returns the solver-effort
    counts ``(n_steps, n_attempts, n_approximations, n_sweeps)`` as ints.

    ``start_seconds`` > 0 RESUMES a partially-computed period: the period
    sink counter is kept instead of reset and stepping continues from the
    checkpointed elapsed time."""
    check_supported(params)
    period = float(period_seconds)
    start = float(start_seconds)

    bp = state.balance_period
    if start <= 0.0:
        state = dataclasses.replace(state, balance_period=BalanceData(
            bp.storage, torch.zeros_like(bp.sink_source), bp.mbe, bp.mbr))

    dt_curr = host_read(state.dt_curr)
    t = start
    stats = [0, 0, 0, 0]
    while t < period:
        state, dt, (na, nap, nsw), _, dt_curr = _compute_step(
            grid, params, state, period - t, dt_curr)
        stats = [stats[0] + 1, stats[1] + na, stats[2] + nap, stats[3] + nsw]
        t = t + dt

    # close the period (water.cpp:143-156)
    cur, per, whole = (state.balance_current, state.balance_period,
                       state.balance_whole)
    whole_sink = whole.sink_source + per.sink_source
    d_period = cur.storage - per.storage
    d_whole = cur.storage - whole.storage
    per_mbe = d_period - per.sink_source
    whole_mbe = d_whole - whole_sink
    # |sink| in the denominator (DEVIATIONS #30: the reference's
    # updateWaterBalanceDataWholePeriod omits the fabs of its per-step twin)
    ref = torch.clamp_min(torch.abs(whole_sink), 0.001)
    whole_mbr = whole_mbe / ref

    state = dataclasses.replace(
        state,
        balance_period=BalanceData(cur.storage, per.sink_source, per_mbe,
                                   per.mbr),
        balance_whole=BalanceData(whole.storage, whole_sink, whole_mbe,
                                  whole_mbr))
    return state, tuple(stats)


def compute_period(grid: Grid, params: SolverParameters, state: WaterState,
                   period_seconds) -> WaterState:
    """Run adaptive steps until ``period_seconds`` is covered, then close
    the period balance (computePeriod, soilFluxes3D.cpp:1760-1777)."""
    state, _ = compute_period_stats(grid, params, state, period_seconds)
    return state

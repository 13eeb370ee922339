"""Adaptive time stepping: Picard outer loop, inner linear solve, dt control.

The port's eager, host-looped water step (CPUSolver::waterMainLoop /
waterApproximationLoop / solveLinearSystem, cpusolver.cpp:143-468,672-703,
and evaluateWaterBalance, water.cpp:165-227) on the one path the cells run:
the float32 psi-carry step (``SolverParameters.fast_f32``) on one whole box,
with conjugate gradient and the vertical-line preconditioner as the inner
solver, and the heat-coupling hooks that solver/coupled.py passes to every
Picard iteration.

The nested loops (period -> step retry -> Picard -> inner solve) are Python
loops: the fields stay on the device, and the host reads the few scalars
each decision needs through :func:`benchmark.reference.device.host_read`
(the Courant number of each assembly, one flag per CG iteration, the MBR of
each balance, and the step size once per call). The scalar arithmetic of
those decisions runs on the host in float64; CG's convergence tests run in
float32. Every select of the step is kept, including those applied whether
or not the step was accepted (best_h, dt_curr, courant, balance_current).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from benchmark.reference import precision
from benchmark.reference.core.grid import Grid
from benchmark.reference.core.state import (BalanceData, SolverParameters,
                                             WaterState)
from benchmark.reference.device import host_read, scalar
from benchmark.reference.solver import water as W

__all__ = ["compute_period_stats", "initialize_balance", "check_supported",
           "CGOperators", "cg_operators", "cg_start", "cg_iteration"]

# step outcome codes (balanceResult_t, types.h:174)
RUNNING = 0
ACCEPTED = 1
REFUSED = 2
HALVED = 3
NAN = 4


def check_supported(params: SolverParameters) -> None:
    """Raise ``ValueError`` for parameters the reference does not run: it
    runs the float32 psi-carry step of ``SolverParameters.fast_f32()``."""
    if not (params.sweep_dtype == torch.float32 and params.dtype == torch.float64):
        raise ValueError("the reference runs SolverParameters.fast_f32(): a float32 "
                         "psi carry over a float64 state")


def initialize_balance(grid: Grid, params: SolverParameters,
                       state: WaterState) -> WaterState:
    """Reset all balance counters to the current storage
    (initializeWaterBalance, water.cpp:35-65)."""
    se = W.compute_se(grid, params, state.h)
    surf, soil = W.water_content_sums(grid, params, state.h, se)
    storage = (surf + soil).to(params.dtype)
    zero = torch.zeros((), dtype=params.dtype, device=grid.device)
    bal = BalanceData(storage=storage, sink_source=zero, mbe=zero, mbr=zero)
    return dataclasses.replace(
        state, h_old=state.h, best_h=state.h, se=se,
        boundary_flow_sum=torch.zeros_like(state.boundary_flow_sum),
        link_flow_sum=torch.zeros_like(state.link_flow_sum),
        balance_prev=bal, balance_current=bal,
        balance_period=bal, balance_whole=bal)


# ----------------------------------------------------------------------
# inner: preconditioned conjugate gradient
# ----------------------------------------------------------------------

class CGOperators(NamedTuple):
    """One CG solve's operators on an assembled system (:func:`cg_operators`):
    the line preconditioner ``precond(s)``, the D-weighted dot product
    ``mdot(a, b)`` and the psi-weighted mean norm ``weight_norm(z, x)``,
    with the system, grid and the working dtype."""
    system: W.LinearSystem
    grid: Grid
    dtype: torch.dtype
    precond: Callable
    mdot: Callable
    weight_norm: Callable


def cg_operators(system: W.LinearSystem, grid: Grid, dt: torch.dtype) -> CGOperators:
    """The operators of :func:`_cg_solve` in the working dtype ``dt``."""
    diag = system.diag.to(dt)
    n_nodes = scalar(float(grid.n_nodes), dt, grid.device)

    def precond(s):
        return torch.where(grid.mask, W.tridiag_vertical_solve(system.c_up, system.c_down, s),
                           0.0)

    def weight_norm(z, x):
        apsi = torch.abs(x)
        w = torch.where(apsi > 1.0, 1.0 / apsi, 1.0)
        return torch.where(grid.mask, torch.abs(z) * w, 0.0).sum() / n_nodes

    def mdot(a, b):
        # <a, b>_D: products in the working dtype, summed in float64 (the
        # balance gate's precision), cast back
        return torch.where(grid.mask, diag * a * b, 0.0).sum(
            dtype=precision.accumulator()).to(dt)

    return CGOperators(system, grid, dt, precond, mdot, weight_norm)


def cg_start(ops: CGOperators, x_init):
    """The solve's start from ``x_init``: ``(s, p, rho, norm0)``, the scaled
    residual, the first direction, r . M^-1 r and the residual's norm."""
    s = torch.where(ops.grid.mask, ops.system.b + W.stencil_apply(ops.system, x_init)
                    - x_init, 0.0)
    p = ops.precond(s)
    return s, p, ops.mdot(s, p), ops.weight_norm(s, x_init)


def cg_iteration(ops: CGOperators, x, s, p, rho, best, tol_t):
    """One iteration of :func:`_cg_solve`'s loop, on the device: the scaled
    matvec, the updates, the norm and the best norm so far. Returns ``(x,
    s, p, rho, best, converged, diverged)``, the flags 0-d tensors (the
    solve reads them together, once an iteration)."""
    mask = ops.grid.mask
    w = torch.where(mask, p - W.stencil_apply(ops.system, p), 0.0)  # D^-1 A p
    pAp = ops.mdot(p, w)
    breakdown = pAp <= 0.0
    # guarded divisions
    alpha = torch.where(breakdown, 0.0, rho / torch.where(pAp != 0.0, pAp, 1.0))
    x = torch.where(mask, x + alpha * p, 0.0)
    s = torch.where(mask, s - alpha * w, 0.0)
    z = ops.precond(s)
    rho_new = ops.mdot(s, z)
    beta = rho_new / torch.where(rho != 0.0, rho, 1.0)
    p = z + beta * p
    norm = ops.weight_norm(s, x)
    converged = norm < tol_t
    div = breakdown | (~converged & (norm > best * 10.0))
    return x, s, p, rho_new, torch.minimum(best, norm), converged, div


def _cg_solve(system: W.LinearSystem, x_init: torch.Tensor, grid: Grid,
              params: SolverParameters, approx: int):
    """Preconditioned conjugate gradient on the assembled system (the
    reference's "lineal" CG/PCG bridge, cpusolver.cpp:608-669) until
    convergence, divergence or the per-approximation cap max(25,
    (approx+1)*maxIter/maxApprox); returns ``(x, diverged, n_iterations)``.

    It works through the stored Jacobi-scaled stencil: ``G(x) = b + Cx``
    gives the scaled residual ``s = G(x) - x``, the scaled matvec is
    ``D^-1 A p = p - C p``, and D-weighted dot products recover the true
    inner products. The line preconditioner solves the vertical
    tridiagonal block exactly per iteration
    (:func:`water.tridiag_vertical_solve`). Convergence uses the
    psi-weighted mean |s| norm against a tolerance of at least 1e-7; the
    surface clamp runs once, at the end. Diverged on breakdown (pAp <= 0)
    or a norm past 10x the best seen.

    The scalars rho, pAp, alpha and beta stay 0-d float32 tensors on the
    device: reading them into Python floats would do CG's scalar arithmetic
    in float64. The host reads one number per iteration, the done/diverged
    flags together, through ``host_read``.
    """
    max_iter = params.max_iterations_for(approx)
    tol = max(params.residual_tolerance, 1e-7)
    ops = cg_operators(system, grid, x_init.dtype)
    tol_t = scalar(tol, ops.dtype, grid.device)
    s, p, rho, norm0 = cg_start(ops, x_init)
    best = torch.maximum(norm0, tol_t)
    # a solve may take no iteration at all
    done = bool(host_read(norm0 < tol_t))
    x, it, diverged = x_init, 0, False
    while not done and it < max_iter:
        x, s, p, rho, best, converged, div = cg_iteration(ops, x, s, p, rho, best, tol_t)
        it += 1
        flags = int(host_read((converged | div).to(torch.int32) + 2 * div.to(torch.int32)))
        done, diverged = flags != 0, flags >= 2

    # the surface clamp once on the solution (JacobiWaterCPU applies it per
    # sweep, water.cpp:583-585; the lineal path not at all): floor 0 in psi
    # form; then the mask
    x = x.clone()
    x[0] = torch.maximum(x[0], torch.zeros_like(x[0]))
    return torch.where(grid.mask, x, 0.0), diverged, it


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
    host (float64 for dt, Courant and MBR)."""

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


def restore_best_step(grid: Grid, params: SolverParameters,
                      h_r: torch.Tensor, h_old: torch.Tensor,
                      sink_source: torch.Tensor, pond: torch.Tensor,
                      prev_storage: torch.Tensor, dt: float, approx: int,
                      boundary_flux_fn=None):
    """restoreBestStep (water.cpp:253-267): saturation, conductivity,
    boundary flows and balance of the best iterate ``h_r`` (float32 psi),
    the fused assembly recomputing flows and k (its stencil discarded);
    returns ``(h_r, se_r, k_r, flow_r, rate_r, balance)``.
    ``boundary_flux_fn`` (the heat-coupling boundary hook) joins the
    flows."""
    se_r = W.compute_se_psi(grid, params, h_r)
    _, flow_r, rate_r, k_r = W.assemble_fast(
        grid, params, h_r, h_old, se_r, sink_source, pond, approx, dt,
        boundary_flux_fn=boundary_flux_fn)
    bal = _balance(grid, params, h_r, se_r, flow_r, prev_storage, dt)
    return h_r, se_r, k_r, flow_r, rate_r, bal


def _balance(grid, params: SolverParameters, h, se, water_flow,
             prev_storage, dt: float) -> tuple:
    """(storage, sink, MBE, MBR) of the domain."""
    surf, soil, flow = W.mass_balance_sums_psi(grid, params, h, se, water_flow)
    return W.balance_from_sums(params, surf, soil, flow, prev_storage, dt)


def _approximation_loop(grid: Grid, params: SolverParameters,
                        h: torch.Tensor, h_old: torch.Tensor,
                        se: torch.Tensor, sink_source: torch.Tensor,
                        pond: torch.Tensor, prev_storage: torch.Tensor,
                        dt: float, dt_curr: float, extra_flux_fn=None,
                        boundary_flux_fn=None) -> _ApproxCarry:
    """One attempt at time step ``dt`` (waterApproximationLoop,
    cpusolver.cpp:392-468): ``h``/``h_old``/``se`` are the float32
    psi-carry fields of the attempt's start and the whole loop runs in
    that representation.

    The heat-coupling hooks are re-evaluated at every Picard iteration
    from float32 signed psi: ``extra_flux_fn(psi, k)`` (the
    invariantFluxes mechanism, water.cpp:329-341, cpusolver.cpp:388)
    enters the RHS only; ``boundary_flux_fn(psi, dt)`` (the HeatSurface
    evaporative sink, water.cpp:708-747) enters the RHS and the balance,
    and the restore branch too. ``dt`` reaches it as a Python float."""
    zero = torch.zeros((), dtype=params.dtype, device=grid.device)
    c = _ApproxCarry(
        approx=0, result=RUNNING, h=h, se=se, k=torch.zeros_like(h),
        water_flow=torch.zeros_like(h), boundary_rate=torch.zeros_like(h),
        best_h=h, best_mbr=math.inf, dt_curr=dt_curr, courant=0.0,
        balance=(zero, zero, zero, zero), n_sweeps=0)

    def evaluate():
        """evaluateWaterBalance (water.cpp:165-227) + accept/restore."""
        approx = c.approx
        storage, sink, mbe, mbr = _balance(grid, params, c.h, c.se,
                                           c.water_flow, prev_storage, dt)
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
            (c.h, c.se, c.k, c.water_flow, c.boundary_rate,
             c.balance) = restore_best_step(grid, params, c.best_h, h_old,
                                            sink_source, pond, prev_storage,
                                            dt, approx, boundary_flux_fn)
        else:
            c.balance = (storage, sink, mbe, mbr)
        c.result, c.dt_curr = result, dt_new

    while c.result == RUNNING and c.approx < params.max_approximations:
        approx = c.approx
        # one fused float32 psi-form pass (capacity + boundary + stencil)
        system, flow, rate, k = W.assemble_fast(
            grid, params, c.h, h_old, c.se, sink_source, pond, approx, dt,
            extra_flux_fn=extra_flux_fn, boundary_flux_fn=boundary_flux_fn)
        courant = host_read(system.courant)

        if courant >= 1.01 and dt > params.delta_t_min:
            # checkCourant (cpusolver.cpp:248-281)
            dt_new = _decimal_floor_dt(c.dt_curr / courant)
            c.result, c.dt_curr = HALVED, max(params.delta_t_min, dt_new)
            c.courant, c.k, c.water_flow, c.boundary_rate = courant, k, flow, rate
            c.approx = approx + 1
            continue

        x, diverged, n_it = _cg_solve(system, c.h, grid, params, approx)
        c.n_sweeps += n_it
        if diverged and dt > params.delta_t_min:
            c.result = HALVED
            c.dt_curr = max(params.delta_t_min, c.dt_curr / 2.0)
            c.courant, c.k, c.water_flow, c.boundary_rate = courant, k, flow, rate
            c.approx = approx + 1
            continue

        c.h = x
        c.se = W.compute_se_psi(grid, params, x)
        c.k, c.water_flow, c.boundary_rate, c.courant = k, flow, rate, courant
        evaluate()
        c.approx = approx + 1
    return c


# ----------------------------------------------------------------------
# outer: step-retry loop (waterMainLoop) and the period
# ----------------------------------------------------------------------

def _compute_step(grid: Grid, params: SolverParameters, state: WaterState,
                  max_time_step: float, dt_curr: float, extra_flux_fn=None,
                  boundary_flux_fn=None):
    """Retry attempts until one is accepted (or fails fatally).

    ``dt_curr`` is ``state.dt_curr`` already on the host. Returns
    ``(state, dt_accepted, (n_attempts, n_approx, n_sweeps),
    boundary_rate, dt_curr)`` with the host copy of the new step size;
    ``boundary_rate`` is the last assembly's, which the heat boundary of
    the coupled step reads. The heat-coupling hooks go to every Picard
    iteration (see :func:`_approximation_loop`)."""
    check_supported(params)
    dtype = params.dtype
    st = state
    n_att = n_app = n_sw = 0

    def to_head(x):
        return torch.where(grid.mask, grid.z + x.to(dtype), 0.0)

    while True:
        dt = min(dt_curr, max_time_step)
        h_old = st.h
        # psi-carry: ONE f64 subtraction per attempt, then the whole
        # Picard loop runs in f32 signed psi
        psi_seed = torch.where(grid.mask, st.h - grid.z, 0.0).to(params.sweep_dtype)
        se_seed = W.compute_se_psi(grid, params, psi_seed)
        out = _approximation_loop(
            grid, params, psi_seed, psi_seed, se_seed, st.sink_source,
            st.pond, st.balance_prev.storage, dt, dt_curr,
            extra_flux_fn, boundary_flux_fn)

        accepted = out.result == ACCEPTED
        # NAN is fatal; a RUNNING leak is treated as fatal too
        fatal = out.result in (NAN, RUNNING)
        storage, sink, mbe, mbr = out.balance

        if accepted:
            # acceptStep (water.cpp:230-251): the f64 state is
            # reconstructed once here
            bp, per = st.balance_prev, st.balance_period
            changes = dict(
                h=to_head(out.h),
                h_old=h_old,
                se=out.se.to(dtype),
                k=out.k.to(dtype),
                boundary_flow_sum=st.boundary_flow_sum + out.boundary_rate.to(dtype) * dt,
                balance_prev=BalanceData(storage, sink, bp.mbe, bp.mbr),
                balance_period=BalanceData(per.storage, per.sink_source + sink,
                                           per.mbe, per.mbr))
        else:
            changes = {}
        # best_h is taken whether or not the attempt was accepted
        st = dataclasses.replace(
            st, best_h=to_head(out.best_h),
            dt_curr=scalar(out.dt_curr, dtype, st.dt_curr.device),
            courant=scalar(out.courant, dtype, st.courant.device),
            balance_current=BalanceData(storage, sink, mbe, mbr),
            **changes)
        dt_curr = out.dt_curr
        n_att, n_app, n_sw = n_att + 1, n_app + out.approx, n_sw + out.n_sweeps
        if accepted or fatal:
            return (st, dt, (n_att, n_app, n_sw), out.boundary_rate.to(dtype), dt_curr)


def compute_period_stats(grid: Grid, params: SolverParameters,
                         state: WaterState, period_seconds):
    """Run adaptive steps until ``period_seconds`` is covered, then close
    the period balance (computePeriod, soilFluxes3D.cpp:1760-1777); returns
    ``(state, (n_steps, n_attempts, n_approximations, n_sweeps))``."""
    check_supported(params)
    period = float(period_seconds)
    bp = state.balance_period
    state = dataclasses.replace(state, balance_period=BalanceData(
        bp.storage, torch.zeros_like(bp.sink_source), bp.mbe, bp.mbr))

    dt_curr = host_read(state.dt_curr)
    t = 0.0
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

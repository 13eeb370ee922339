"""Adaptive time stepping: Picard outer loop, inner linear solve, dt control.

PyTorch counterpart of ``criteria3d_tpu/solver/step.py``
(CPUSolver::waterMainLoop / waterApproximationLoop / solveLinearSystem,
cpusolver.cpp:143-468,672-703, and evaluateWaterBalance,
water.cpp:165-227): the float64 parity path and the float32 psi-carry path,
with per-sweep Jacobi, the bundled Jacobi kernel or conjugate gradient as
the inner solver, the per-link flow accounting, and the heat-coupling
hooks that solver/coupled.py passes to every Picard iteration.

The JAX package runs the nested loops (period -> step retry -> Picard ->
inner solve) on the device inside ``lax.while_loop``s. Here they are Python
loops: the fields stay on the device, and the host reads the few scalars
each decision needs through :func:`criteria3d_tpu_torch.device.host_read`
(the Courant number of each assembly, the norm of each sweep or bundle, one
flag per CG iteration, the MBR of each balance, and the step size once per
call). The scalar arithmetic of those decisions runs on the host in
float64, the type JAX uses for it; the inner solver's convergence tests run
in the sweep dtype. Every select of the JAX step is reproduced, including
those applied whether or not the step was accepted (best_h, dt_curr,
courant, balance_current).

With ``params.mesh`` the step runs on the blocks of ``shard_pytree``'s grid
and state, as JAX's GSPMD partitions it: the field arithmetic goes through
:func:`~criteria3d_tpu_torch.parallel.sharding.bmap` (once on the whole
tensors without a mesh, so that path runs the same kernels as before),
every global sum is a per-block partial over owned cells added on
``mesh.home`` before the decision's single host read, and each stencil
reads fresh rings: the state fields keep theirs fresh (the solvers end
with an exchange), the bundle exchanges x once a bundle, CG exchanges p
once an iteration and per-sweep Jacobi x once every ``RING`` sweeps. The
assembly on a grown block is exact on all but its outer cell, so no
coefficient is exchanged. The heat-coupling hooks are then a
:class:`~criteria3d_tpu_torch.parallel.sharding.Blocked` of per-block
closures (solver/coupled.py builds them), which ``bmap`` hands to each
block's assembly like any other blocked argument.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from criteria3d_tpu_torch.core.grid import Grid
from criteria3d_tpu_torch.core.state import (BalanceData, SolverParameters,
                                             WaterState)
from criteria3d_tpu_torch.device import host_read, scalar
from criteria3d_tpu_torch.parallel.sharding import (RING, Blocked, block_max,
                                                    block_sum, bmap, exchange,
                                                    first_block, is_field, owned,
                                                    unzip)
from criteria3d_tpu_torch.solver import water as W
from criteria3d_tpu_torch.solver.jacobi_bundle import jacobi_solve_loop
from criteria3d_tpu_torch.solver.shifts import LATERAL_OFFSETS, shift2d

# torch.profiler ranges of a Picard iteration: the device time of the
# kernels each one launches is what a profiled run attributes to assembly
# and inner solve (chip_smoke.py reads them)
ASSEMBLE_RANGE = "c3d.assemble"
SOLVE_RANGE = "c3d.inner_solve"

__all__ = ["compute_step", "compute_period", "compute_period_stats",
           "initialize_balance", "check_supported", "restore_best_step",
           "CGOperators", "cg_operators", "cg_start", "cg_iteration"]

# step outcome codes (balanceResult_t, types.h:174)
RUNNING = 0
ACCEPTED = 1
REFUSED = 2
HALVED = 3
NAN = 4


def _is_fast(params: SolverParameters) -> bool:
    """The float32 psi-carry path: a sweep dtype other than the state's."""
    return params.sweep_dtype is not None and params.sweep_dtype != params.dtype


def check_supported(params: SolverParameters) -> None:
    """Raise ``ValueError`` for a configuration no solver runs: an unknown
    sweep dtype, inner solver or CG preconditioner."""
    if params.sweep_dtype not in (None, torch.float32, torch.float64):
        raise ValueError(f"sweep_dtype={params.sweep_dtype}: float32, float64 "
                         "or None")
    if params.inner_solver not in ("jacobi", "cg"):
        raise ValueError(f"unknown inner_solver {params.inner_solver!r}")
    if params.inner_solver == "cg" and params.cg_precond not in ("diag", "line"):
        raise ValueError(f"unknown cg_precond {params.cg_precond!r} (the "
                         "solver takes 'diag' or 'line')")


def _check_blocks(grid, params: SolverParameters, *states) -> None:
    """Raise ``ValueError`` unless grid and states (a water state, and the
    heat state and boundary of the coupled step) are all whole with no
    mesh, or all blocked over ``params.mesh`` in a form the partitioned
    step runs: no quiet gathering to one device."""
    mesh = params.mesh
    fields = [getattr(st, f.name) for st in states for f in dataclasses.fields(st)]
    blocked = [v for v in fields if isinstance(v, Blocked)]
    if mesh is None:
        if isinstance(grid, Blocked) or blocked:
            raise ValueError("blocked grid or state with params.mesh None: set "
                             "SolverParameters.mesh to the mesh they were sharded "
                             "over, or join them with gather_pytree")
        return
    # a field shard_pytree would have cut, left whole
    whole = [v for v in fields if isinstance(v, torch.Tensor) and is_field(v)]
    if not (isinstance(grid, Blocked) and grid.mesh is mesh and not whole
            and all(f.mesh is mesh for f in blocked)):
        raise ValueError("params.mesh is set: cut grid and states over it with "
                         "criteria3d_tpu_torch.parallel.sharding.shard_pytree(x, "
                         "params.mesh)")
    if params.use_pallas:
        if params.sweep_dtype != torch.float32:
            raise ValueError("use_pallas on a mesh runs the float32 bundle: set "
                             "sweep_dtype=torch.float32 (fast_f32)")


def _home(grid) -> torch.device:
    """Where the 0-d values of a step live: the grid's device, or its
    mesh's home device."""
    return grid.mesh.home if isinstance(grid, Blocked) else grid.device


def _ring(grid) -> int:
    return RING if isinstance(grid, Blocked) else 0


def initialize_balance(grid: Grid, params: SolverParameters,
                       state: WaterState) -> WaterState:
    """Reset all balance counters to the current storage
    (initializeWaterBalance, water.cpp:35-65)."""
    ring = _ring(grid)
    se = bmap(lambda g, h: W.compute_se(g, params, h), grid, state.h)
    surf, soil = unzip(bmap(lambda g, h, se_b: W.water_content_sums(
        g, params, h, se_b, ring), grid, state.h, se))
    storage = (block_sum(surf) + block_sum(soil)).to(params.dtype)
    zero = torch.zeros((), dtype=params.dtype, device=_home(grid))
    bal = BalanceData(storage=storage, sink_source=zero, mbe=zero, mbr=zero)
    return dataclasses.replace(
        state, h_old=state.h, best_h=state.h, se=se,
        boundary_flow_sum=bmap(torch.zeros_like, state.boundary_flow_sum),
        link_flow_sum=bmap(torch.zeros_like, state.link_flow_sum),
        balance_prev=bal, balance_current=bal,
        balance_period=bal, balance_whole=bal)


# ----------------------------------------------------------------------
# inner: Jacobi iterations or conjugate gradient
# ----------------------------------------------------------------------

def _jacobi_solve(system: W.LinearSystem, x0: torch.Tensor, grid: Grid,
                  params: SolverParameters, approx: int):
    """Run the inner solver until convergence, divergence or the
    per-approximation cap max(25, (approx+1)*maxIter/maxApprox); returns
    ``(x, diverged, n_iterations)``.

    The selection is the JAX package's: CG when ``inner_solver == "cg"``
    (either path); else the bundled kernel only on the fast path with
    ``use_pallas`` (K sweeps per call, checked every K); else one sweep
    per check (:func:`water.jacobi_sweep_psi` on the fast path,
    :func:`water.jacobi_sweep` on the float64 one). On the fast path the
    tolerance is at least 1e-7, for CG too; the float64 path keeps
    ``residual_tolerance`` as it is.

    On a mesh ``system``, ``x0`` and the returned x are blocked, x with
    fresh rings."""
    max_iter = params.max_iterations_for(approx)
    tol = params.residual_tolerance
    fast = _is_fast(params)
    if fast:
        tol = max(tol, 1e-7)
    n_nodes = first_block(grid).n_nodes

    if params.inner_solver == "cg":
        return _cg_solve(system, x0, grid, params, max_iter, tol,
                         psi_form=fast)

    if fast and params.use_pallas:
        mask_f = bmap(lambda g: g.mask.to(params.sweep_dtype), grid)
        b, c_up, c_down, c_lat = (bmap(lambda sy, k=k: sy[k], system)
                                  for k in range(4))
        return jacobi_solve_loop(b, c_up, c_down, c_lat, mask_f, x0, max_iter,
                                 tol, n_nodes, mesh=params.mesh)

    # the comparisons run in the sweep dtype, as in JAX: float32 on the
    # fast path (tol rounded to float32), float64 on the parity path
    ftype = np.float32 if fast else np.float64
    sweep = W.jacobi_sweep_psi_sum if fast else W.jacobi_sweep_sum
    ring = _ring(grid)
    tol_s, ten, best = ftype(tol), ftype(10.0), ftype(1.0)
    # a sweep leaves the outer cell of a block stale, so the owned cells
    # stay exact for ``ring`` sweeps between exchanges
    x, it, done, diverged, stale = x0, 0, False, False, 0
    while not done and it < max_iter:
        x, total = unzip(bmap(lambda sy, xb, g: sweep(sy, xb, g, ring),
                              system, x, grid))
        total = block_sum(total)
        norm = total / scalar(float(n_nodes), total.dtype, total.device)
        norm = ftype(host_read(norm))
        converged = bool(norm < tol_s)
        diverged = (not converged) and bool(norm > best * ten)
        best = np.minimum(best, norm)
        it += 1
        done = converged or diverged
        stale += 1
        if ring and (stale == ring or done or it >= max_iter):
            x, stale = exchange(x), 0
    return x, diverged, it


class CGOperators(NamedTuple):
    """One CG solve's operators on an assembled system (:func:`cg_operators`):
    the preconditioner ``precond(s)``, the D-weighted dot product
    ``mdot(a, b)`` and the psi-weighted mean norm ``weight_norm(z, x)``, each
    over the blocks on a mesh, with the system, grid, ring width, the
    working dtype and the heads' elevation field in that dtype."""
    system: W.LinearSystem
    grid: Grid
    ring: int
    dtype: torch.dtype
    z_field: torch.Tensor
    precond: Callable
    mdot: Callable
    weight_norm: Callable


def cg_operators(system: W.LinearSystem, grid: Grid, params: SolverParameters,
                 psi_form: bool, dt: torch.dtype) -> CGOperators:
    """The operators of :func:`_cg_solve` in the working dtype ``dt``."""
    home = _home(grid)
    ring = _ring(grid)
    diag = bmap(lambda sy: sy.diag.to(dt), system)
    z_field = bmap(lambda g: g.z.to(dt), grid)
    line = params.cg_precond == "line"
    n_nodes = scalar(float(first_block(grid).n_nodes), dt, home)

    def precond_block(sy, g, s):
        if line:
            return torch.where(g.mask, W.tridiag_vertical_solve(
                sy.c_up, sy.c_down, s), 0.0)
        return s

    def precond(s):
        return bmap(precond_block, system, grid, s)

    def weight_sum(g, zf, z, x):
        apsi = torch.abs(x) if psi_form else torch.abs(x - zf)
        w = torch.where(apsi > 1.0, 1.0 / apsi, 1.0)
        return owned(torch.where(g.mask, torch.abs(z) * w, 0.0), ring).sum()

    def weight_norm(z, x):
        return block_sum(bmap(weight_sum, grid, z_field, z, x)) / n_nodes

    def dot_sum(g, d, a, b):
        return owned(torch.where(g.mask, d * a * b, 0.0), ring).sum(
            dtype=torch.float64)

    def mdot(a, b):
        # <a, b>_D: products in the working dtype, summed in float64 (the
        # balance gate's precision), cast back
        return block_sum(bmap(dot_sum, grid, diag, a, b)).to(dt)

    return CGOperators(system, grid, ring, dt, z_field, precond, mdot, weight_norm)


def cg_start(ops: CGOperators, x_init):
    """The solve's start from ``x_init``: ``(s, p, rho, norm0)``, the scaled
    residual, the first direction, r . M^-1 r and the residual's norm."""
    s = bmap(lambda sy, g, x: torch.where(
        g.mask, sy.b + W.stencil_apply(sy, x) - x, 0.0), ops.system, ops.grid, x_init)
    p = ops.precond(s)
    return s, p, ops.mdot(s, p), ops.weight_norm(s, x_init)


def cg_iteration(ops: CGOperators, x, s, p, rho, best, tol_t):
    """One iteration of :func:`_cg_solve`'s loop, on the device: p's rings
    exchanged on a mesh, the scaled matvec, the updates, the norm and the
    best norm so far. Returns ``(x, s, p, rho, best, converged,
    diverged)``, the flags 0-d tensors (the solve reads them together,
    once an iteration)."""
    system, grid = ops.system, ops.grid
    if ops.ring:
        p = exchange(p)
    w = bmap(lambda sy, g, p: torch.where(
        g.mask, p - W.stencil_apply(sy, p), 0.0), system, grid, p)  # D^-1 A p
    pAp = ops.mdot(p, w)
    breakdown = pAp <= 0.0
    # guarded divisions, as in JAX (step.py:205, :210)
    alpha = torch.where(breakdown, 0.0,
                        rho / torch.where(pAp != 0.0, pAp, 1.0))
    x = bmap(lambda g, x, p: torch.where(
        g.mask, x + alpha.to(x.device) * p, 0.0), grid, x, p)
    s = bmap(lambda g, s, w: torch.where(
        g.mask, s - alpha.to(s.device) * w, 0.0), grid, s, w)
    z = ops.precond(s)
    rho_new = ops.mdot(s, z)
    beta = rho_new / torch.where(rho != 0.0, rho, 1.0)
    p = bmap(lambda z, p: z + beta.to(z.device) * p, z, p)
    norm = ops.weight_norm(s, x)
    converged = norm < tol_t
    div = breakdown | (~converged & (norm > best * 10.0))
    return x, s, p, rho_new, torch.minimum(best, norm), converged, div


def _cg_solve(system: W.LinearSystem, x_init: torch.Tensor, grid: Grid,
              params: SolverParameters, max_iter: int, tol: float,
              psi_form: bool):
    """Preconditioned conjugate gradient on the assembled system (the
    reference's "lineal" CG/PCG bridge, cpusolver.cpp:608-669); returns
    ``(x, diverged, n_iterations)``.

    It works through the stored Jacobi-scaled stencil: ``G(x) = b + Cx``
    gives the scaled residual ``s = G(x) - x``, the scaled matvec is
    ``D^-1 A p = p - C p``, and D-weighted dot products recover the true
    inner products. ``cg_precond`` "line" solves the vertical tridiagonal
    block exactly per iteration (:func:`water.tridiag_vertical_solve`),
    "diag" is plain Jacobi preconditioning (z = s). Convergence uses the
    Jacobi path's psi-weighted mean |s| norm; the surface clamp runs once,
    at the end. Diverged on breakdown (pAp <= 0) or a norm past 10x the
    best seen.

    The scalars rho, pAp, alpha and beta stay 0-d tensors on the device in
    the working dtype (float32 on the fast path): reading them into Python
    floats would do CG's scalar arithmetic in float64 and the iterates
    would drift from JAX's. The host reads one number per iteration, the
    done/diverged flags together, through ``host_read``.

    On a mesh the dot products and norms are per-block partials over owned
    cells added on ``mesh.home``, and p's rings are exchanged before each
    matvec; x then stays exact on the rings (every update adds a fresh p),
    so the solution leaves with fresh rings.
    """
    ops = cg_operators(system, grid, params, psi_form, first_block(x_init).dtype)
    tol_t = scalar(tol, ops.dtype, _home(grid))
    s, p, rho, norm0 = cg_start(ops, x_init)
    best = torch.maximum(norm0, tol_t)
    # a solve may take no iteration at all
    done = bool(host_read(norm0 < tol_t))
    x, it, diverged = x_init, 0, False
    while not done and it < max_iter:
        x, s, p, rho, best, converged, div = cg_iteration(ops, x, s, p, rho, best, tol_t)
        it += 1
        flags = int(host_read((converged | div).to(torch.int32)
                              + 2 * div.to(torch.int32)))
        done, diverged = flags != 0, flags >= 2

    # the surface clamp once on the solution (JacobiWaterCPU applies it per
    # sweep, water.cpp:583-585; the lineal path not at all): floor 0 in psi
    # form, z[0] in head form; then the mask. It runs on the rings too.
    def clamp(g, zf, x):
        floor0 = torch.zeros_like(zf[0]) if psi_form else zf[0]
        x = x.clone()
        x[0] = torch.maximum(x[0], floor0)
        return torch.where(g.mask, x, 0.0)
    return bmap(clamp, grid, ops.z_field, x), diverged, it


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
    h: torch.Tensor            # float32 signed psi, or float64 total head
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
    # physical (un-preconditioned) conductances of the last solved
    # assembly, kept only when params.track_link_flow (else None)
    a_up: torch.Tensor | None
    a_lat: torch.Tensor | None


def restore_best_step(grid: Grid, params: SolverParameters,
                      h_r: torch.Tensor, h_old: torch.Tensor,
                      sink_source: torch.Tensor, pond: torch.Tensor,
                      prev_storage: torch.Tensor, dt: float, approx: int,
                      boundary_flux_fn=None):
    """restoreBestStep (water.cpp:253-267): saturation, conductivity,
    boundary flows and balance of the best iterate ``h_r``, without the
    linear system; returns ``(h_r, se_r, k_r, flow_r, rate_r, balance)``.

    On the fast path ``h_r``/``h_old`` are float32 psi and the fused
    assembly recomputes flows and k (its stencil is discarded); on the
    float64 path capacity, boundary flows and balance are recomputed.
    ``boundary_flux_fn`` (the heat-coupling boundary hook; on a mesh a
    Blocked of per-block closures) joins the flows on either path. Restores are rare: ``restore_best_step.count`` counts
    them (reset it to 0 before a run)."""
    restore_best_step.count += 1

    def restore(g, h_r, h_old, sink_source, pond, boundary_flux_fn):
        if _is_fast(params):
            se_r = W.compute_se_psi(g, params, h_r)
            _, flow_r, rate_r, k_r = W.assemble_fast(
                g, params, h_r, h_old, se_r, sink_source, pond, approx, dt,
                boundary_flux_fn=boundary_flux_fn)
        else:
            se_r = W.compute_se(g, params, h_r)
            _, k_r = W.compute_capacity(g, params, h_r, h_old, se_r)
            flow_r, rate_r = W.update_boundary_water(
                g, params, h_r, h_old, k_r, sink_source, pond, dt)
            if boundary_flux_fn is not None:
                br_r = boundary_flux_fn(h_r - g.z, dt)
                flow_r = flow_r + br_r
                rate_r = rate_r + br_r
        return se_r, k_r, flow_r, rate_r
    se_r, k_r, flow_r, rate_r = unzip(bmap(restore, grid, h_r, h_old,
                                           sink_source, pond, boundary_flux_fn))
    bal = _balance(grid, params, h_r, se_r, flow_r, prev_storage, dt)
    return h_r, se_r, k_r, flow_r, rate_r, bal


restore_best_step.count = 0


def _balance(grid, params: SolverParameters, h, se, water_flow,
             prev_storage, dt: float) -> tuple:
    """(storage, sink, MBE, MBR) of the domain: the blocks' sums over
    their owned cells combined on the home device."""
    sums = W.mass_balance_sums_psi if _is_fast(params) else W.mass_balance_sums
    ring = _ring(grid)
    surf, soil, flow = unzip(bmap(lambda g, h, se, wf: sums(g, params, h, se, wf, ring),
                                  grid, h, se, water_flow))
    return W.balance_from_sums(params, block_sum(surf), block_sum(soil),
                               block_sum(flow), prev_storage, dt)


def _assemble(g: Grid, params: SolverParameters, h, h_old, se, sink_source,
              pond, approx: int, dt: float, extra_flux_fn, boundary_flux_fn):
    """One block's (system, water_flow, boundary_rate, k) of a Picard
    iteration: the fused float32 psi-form pass on the fast path, else
    capacity + boundary flows + assemble_system, each with the hooks."""
    if _is_fast(params):
        # one fused float32 psi-form pass (capacity + boundary + stencil)
        return W.assemble_fast(g, params, h, h_old, se, sink_source, pond,
                               approx, dt, extra_flux_fn=extra_flux_fn,
                               boundary_flux_fn=boundary_flux_fn)
    capacity, k = W.compute_capacity(g, params, h, h_old, se)
    flow, rate = W.update_boundary_water(g, params, h, h_old, k, sink_source,
                                         pond, dt)
    if boundary_flux_fn is not None or extra_flux_fn is not None:
        psi64 = h - g.z
    if boundary_flux_fn is not None:
        br = boundary_flux_fn(psi64, dt)
        flow = flow + br
        rate = rate + br
    flow_rhs = flow if extra_flux_fn is None else flow + extra_flux_fn(psi64, k)
    system = W.assemble_system(g, params, h, h_old, k, flow_rhs, capacity,
                               pond, approx, dt)
    return system, flow, rate, k


def _approximation_loop(grid: Grid, params: SolverParameters,
                        h: torch.Tensor, h_old: torch.Tensor,
                        se: torch.Tensor, sink_source: torch.Tensor,
                        pond: torch.Tensor, prev_storage: torch.Tensor,
                        dt: float, dt_curr: float, extra_flux_fn=None,
                        boundary_flux_fn=None) -> _ApproxCarry:
    """One attempt at time step ``dt`` (waterApproximationLoop,
    cpusolver.cpp:392-468). On the fast path ``h``/``h_old``/``se`` are
    the float32 psi-carry fields of the attempt's start and the whole loop
    runs in that representation; on the float64 path they are total heads
    and the loop runs compute_capacity + update_boundary_water +
    assemble_system.

    The heat-coupling hooks are re-evaluated at every Picard iteration
    from SIGNED psi (float32 on the fast path, float64 otherwise):
    ``extra_flux_fn(psi, k)`` (the invariantFluxes mechanism,
    water.cpp:329-341, cpusolver.cpp:388) enters the RHS only;
    ``boundary_flux_fn(psi, dt)`` (the HeatSurface evaporative sink,
    water.cpp:708-747) enters the RHS and the balance, and the restore
    branch too. ``dt`` reaches it as a Python float."""
    fast = _is_fast(params)
    zero = torch.zeros((), dtype=params.dtype, device=_home(grid))
    if params.track_link_flow:
        # zeros of the system's dtype (float32 on the fast path)
        a_up0 = bmap(torch.zeros_like, h)
        a_lat0 = bmap(lambda t: torch.zeros((8,) + tuple(t.shape), dtype=t.dtype,
                                            device=t.device), h)
    else:
        a_up0 = a_lat0 = None
    c = _ApproxCarry(
        approx=0, result=RUNNING, h=h, se=se, k=bmap(torch.zeros_like, h),
        water_flow=bmap(torch.zeros_like, h),
        boundary_rate=bmap(torch.zeros_like, h),
        best_h=h, best_mbr=math.inf, dt_curr=dt_curr, courant=0.0,
        balance=(zero, zero, zero, zero), n_sweeps=0, a_up=a_up0,
        a_lat=a_lat0)

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
        with torch.profiler.record_function(ASSEMBLE_RANGE):
            system, flow, rate, k = unzip(bmap(
                lambda g, h, ho, se, sk, pd, xf, bf: _assemble(
                    g, params, h, ho, se, sk, pd, approx, dt, xf, bf),
                grid, c.h, h_old, c.se, sink_source, pond, extra_flux_fn,
                boundary_flux_fn))
        courant = host_read(block_max(bmap(lambda sy: sy.courant, system)))

        if courant >= 1.01 and dt > params.delta_t_min:
            # checkCourant (cpusolver.cpp:248-281)
            dt_new = _decimal_floor_dt(c.dt_curr / courant)
            c.result, c.dt_curr = HALVED, max(params.delta_t_min, dt_new)
            c.courant, c.k, c.water_flow, c.boundary_rate = courant, k, flow, rate
            c.approx = approx + 1
            continue

        with torch.profiler.record_function(SOLVE_RANGE):
            x, diverged, n_it = _jacobi_solve(system, c.h, grid, params, approx)
        c.n_sweeps += n_it
        if diverged and dt > params.delta_t_min:
            c.result = HALVED
            c.dt_curr = max(params.delta_t_min, c.dt_curr / 2.0)
            c.courant, c.k, c.water_flow, c.boundary_rate = courant, k, flow, rate
            c.approx = approx + 1
            continue

        c.h = x
        se_fn = W.compute_se_psi if fast else W.compute_se
        c.se = bmap(lambda g, xb: se_fn(g, params, xb), grid, x)
        c.k, c.water_flow, c.boundary_rate, c.courant = k, flow, rate, courant
        if params.track_link_flow:
            # physical conductances from the preconditioned stencil
            # (updateLinkFlux analogue, water.cpp:269-277), taken only here
            c.a_up = bmap(lambda sy: sy.c_up * sy.diag, system)
            c.a_lat = bmap(lambda sy: sy.c_lat * sy.diag[None], system)
        evaluate()
        c.approx = approx + 1
    return c


def _link_flows(grid: Grid, params: SolverParameters, h_n: torch.Tensor,
                a_up: torch.Tensor, a_lat: torch.Tensor,
                dt: float) -> torch.Tensor:
    """Per-link flows [m3] of an accepted step, (10, L, R, C): up, down and
    the 8 lateral links, positive = inflow to the node (linkData
    waterFlowSum, water.cpp:269-277, with physical conductances). The psi
    form adds the static per-link dz (vert_dist, dz_lat) to its head
    differences and is summed in float64, as JAX's promotion by the float64
    dt does; the float64 form differences total heads. On a block the
    flows are exact on all but its outer cell (the heads' rings are
    fresh)."""
    a_down = torch.roll(a_up, -1, dims=0)
    a_down[-1] = 0.0
    if _is_fast(params):
        g32 = grid.astype(params.sweep_dtype)
        vd32, dzl32 = g32.vert_dist, g32.dz_lat
        f_up = a_up * (torch.roll(h_n, 1, dims=0) - h_n + vd32)
        f_down = a_down * (torch.roll(h_n, -1, dims=0) - h_n
                           - torch.roll(vd32, -1, dims=0))
        f_lat = [a_lat[i] * (shift2d(h_n, di, dj) - h_n + dzl32[i])
                 for i, (di, dj) in enumerate(LATERAL_OFFSETS)]
    else:
        f_up = a_up * (torch.roll(h_n, 1, dims=0) - h_n)
        f_down = a_down * (torch.roll(h_n, -1, dims=0) - h_n)
        f_lat = [a_lat[i] * (shift2d(h_n, di, dj) - h_n)
                 for i, (di, dj) in enumerate(LATERAL_OFFSETS)]
    return torch.stack([f.to(params.dtype) * dt
                        for f in [f_up, f_down] + f_lat])


# ----------------------------------------------------------------------
# outer: step-retry loop (waterMainLoop) and the public API
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
    iteration (see :func:`_approximation_loop`). On a mesh grid and state
    are blocked (:func:`_check_blocks`)."""
    check_supported(params)
    _check_blocks(grid, params, state)
    dtype = params.dtype
    fast = _is_fast(params)
    st = state
    n_att = n_app = n_sw = 0
    while True:
        dt = min(dt_curr, max_time_step)
        h_old = st.h
        if fast:
            # psi-carry: ONE f64 subtraction per attempt, then the whole
            # Picard loop runs in f32 signed psi
            psi_seed = bmap(lambda g, h: torch.where(g.mask, h - g.z, 0.0).to(
                params.sweep_dtype), grid, st.h)
            se_seed = bmap(lambda g, p: W.compute_se_psi(g, params, p), grid,
                           psi_seed)
            out = _approximation_loop(
                grid, params, psi_seed, psi_seed, se_seed, st.sink_source,
                st.pond, st.balance_prev.storage, dt, dt_curr,
                extra_flux_fn, boundary_flux_fn)
        else:
            se = bmap(lambda g, h: W.compute_se(g, params, h), grid, st.h)
            out = _approximation_loop(
                grid, params, st.h, h_old, se, st.sink_source, st.pond,
                st.balance_prev.storage, dt, dt_curr,
                extra_flux_fn, boundary_flux_fn)

        accepted = out.result == ACCEPTED
        # NAN is fatal; a RUNNING leak is treated as fatal too
        fatal = out.result in (NAN, RUNNING)
        storage, sink, mbe, mbr = out.balance

        def to_head(g, x):
            return torch.where(g.mask, g.z + x.to(dtype), 0.0)

        # best_h is taken whether or not the attempt was accepted
        best_acc = bmap(to_head, grid, out.best_h) if fast else out.best_h
        if accepted:
            # acceptStep (water.cpp:230-251); on the fast path the f64
            # state is reconstructed once here
            bp, per = st.balance_prev, st.balance_period
            h_acc = bmap(to_head, grid, out.h) if fast else out.h
            changes = dict(
                h=h_acc,
                h_old=h_old,
                se=bmap(lambda t: t.to(dtype), out.se),
                k=bmap(lambda t: t.to(dtype), out.k),
                boundary_flow_sum=bmap(lambda b, r: b + r.to(dtype) * dt,
                                       st.boundary_flow_sum, out.boundary_rate),
                balance_prev=BalanceData(storage, sink, bp.mbe, bp.mbr),
                balance_period=BalanceData(per.storage,
                                           per.sink_source + sink,
                                           per.mbe, per.mbr))
            if params.track_link_flow:
                # link_flow_sum changes only on accepted steps
                changes["link_flow_sum"] = bmap(
                    lambda g, lf, h, a_up, a_lat: lf + _link_flows(
                        g, params, h, a_up, a_lat, dt),
                    grid, st.link_flow_sum, out.h, out.a_up, out.a_lat)
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
                    bmap(lambda t: t.to(dtype), out.boundary_rate), dt_curr)


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

"""Adaptive time stepping: Picard outer loop, inner linear solve, dt control.

PyTorch counterpart of ``criteria3d_tpu/solver/step.py``
(CPUSolver::waterMainLoop / waterApproximationLoop / solveLinearSystem,
cpusolver.cpp:143-468,672-703, and evaluateWaterBalance,
water.cpp:165-227): the float64 parity path and the float32 psi-carry path,
with per-sweep Jacobi, the bundled Jacobi kernel or conjugate gradient as
the inner solver, the per-link flow accounting, and the heat-coupling
hooks that solver/coupled.py passes to every Picard iteration.

The JAX package runs the nested loops (period -> step retry -> Picard ->
inner solve) on the device inside ``lax.while_loop``s with scalar carries.
Here they are one flat state machine, :class:`_Machine`: its carries
(JAX's ``_ApproxCarry`` and ``_StepCarry`` and the period's t and stats)
are 0-d tensors on the device, float64 for dt, Courant, MBR and t, int64
for counters and codes, and a ``phase`` among them names the unit of work
that runs next (start an attempt, assemble, cut dt on Courant, start /
iterate / end the inner solve or halve dt on its divergence, evaluate the
balance, keep the best iterate, restore it, end the attempt, accept). Each unit reproduces JAX's
select form line by line, into the carries: accept, halve, restore, NaN,
dt growth, best-step tracking, the Courant cut, CG's and the Jacobi
loops' stops. A branch that replaces whole fields (the best iterate, the
restore, the accepted update) is a unit of its own that the phase guards.
solver/device_loop.py drives the machine: as CUDA graphs on one card,
whole or in blocks (the host reads once per launch of up to
``UNITS_PER_LAUNCH`` units), or unit by unit from Python, reading the phase
after each unit that decides from data (the CPU): ``_Machine.follows``
names what follows the others. On a mesh whose blocks several machines run
(one per card, or ``make_mesh``'s ``machines``), each machine holds its
blocks' part of every buffer and its own scalars, and the rounds driver
runs them side by side, joined at every sum, maximum and ring refresh
(``sharding.combine``).
solver/coupled.py's machine is a larger one: its water step hands on to
its heat units (``step_end``) and its hooks read its buffers.

With ``params.mesh`` the step runs on the blocks of ``shard_pytree``'s grid
and state, as JAX's GSPMD partitions it: the field arithmetic goes through
:func:`~criteria3d_tpu_torch.parallel.sharding.bmap` (once on the whole
tensors without a mesh, so that path runs the same kernels as before),
every global sum is a per-block partial over owned cells added on
``mesh.home``, and each stencil reads fresh rings: the state fields keep
theirs fresh (the solvers end with an exchange), the bundle exchanges x
once a bundle, CG exchanges p once an iteration and per-sweep Jacobi x once
every ``RING`` sweeps and at the solve's end (a unit of its own, which the
phase guards from the sweep count on the device). The assembly on a grown block is
exact on all but its outer cell, so no coefficient is exchanged. The
heat-coupling hooks are then a
:class:`~criteria3d_tpu_torch.parallel.sharding.Blocked` of per-block
closures (solver/coupled.py builds them), which ``bmap`` hands to each
block's assembly like any other blocked argument.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import torch

from criteria3d_tpu_torch.core.grid import Grid
from criteria3d_tpu_torch.core.state import (BalanceData, SolverParameters,
                                             WaterState)
from criteria3d_tpu_torch.device import host_array, host_read, scalar, tally
from criteria3d_tpu_torch.parallel.sharding import (RING, Blocked, block_max,
                                                    block_sum, bmap, combine,
                                                    exchange, first_block, holds_home,
                                                    home_of, is_field, merge,
                                                    owned, part, unzip)
from criteria3d_tpu_torch.solver import device_loop
from criteria3d_tpu_torch.solver import water as W
from criteria3d_tpu_torch.solver.jacobi_bundle import (SWEEPS_PER_BUNDLE,
                                                       jacobi_bundle, mesh_bundle,
                                                       sweep_test)
from criteria3d_tpu_torch.solver.assemble_kernel import _library as _assemble_library
from criteria3d_tpu_torch.solver.jacobi_bundle import _library as _bundle_library
from criteria3d_tpu_torch.solver.shifts import LATERAL_OFFSETS, shift2d

# torch.profiler ranges of a Picard iteration: the device time of the
# kernels each one launches is what a profiled run attributes to assembly
# and inner solve (chip_smoke.py reads them)
ASSEMBLE_RANGE = "c3d.assemble"
SOLVE_RANGE = "c3d.inner_solve"

__all__ = ["compute_step", "compute_period", "compute_period_stats",
           "initialize_balance", "check_supported", "restore_best_step",
           "CGOperators", "cg_operators", "cg_start", "cg_iteration", "cg_clamp"]

# step outcome codes (balanceResult_t, types.h:174)
RUNNING = 0
ACCEPTED = 1
REFUSED = 2
HALVED = 3
NAN = 4

# the machine's phases: each names the unit that runs next (DONE: none)
DONE = 0
START = 1           # an attempt: dt, the psi seed, the attempt's carry
ASSEMBLE = 2        # assembly and the Courant check
COURANT_CUT = 3     # checkCourant's decimal floor of dt
SOLVE_INIT = 4      # the inner solve's start
SOLVE = 5           # one CG iteration, Jacobi sweep or bundle
SOLVE_END = 6       # the clamp, se, the link-flow conductances
EVALUATE = 7        # the balance and the accept / halve / restore decision
STORE_BEST = 8      # the best iterate so far
RESTORE = 9         # restoreBestStep
ATTEMPT_END = 10    # retry, or end the step (fatal)
ACCEPT = 11         # acceptStep, and the step's end
HALVE = 12          # a divergence that halves dt
X_EXCHANGE = 13     # on a mesh, x's rings refreshed (every RING sweeps, and at the end)

# passes of _decimal_floor_dt's loop: exact for dt / Courant >= 1e-24 s
FLOOR_DT_PASSES = 24


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
    mesh's home device (on a machine's part, the machine's device)."""
    return home_of(grid) if isinstance(grid, Blocked) else grid.device


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
# the inner solvers' pieces: conjugate gradient (the Jacobi sweeps are in
# water.py, the bundle in jacobi_bundle.py)
# ----------------------------------------------------------------------

class CGOperators(NamedTuple):
    """One CG solve's operators on an assembled system (:func:`cg_operators`):
    the preconditioner ``precond(s)`` and the D-weighted dot product
    ``mdot(a, b)``, each over the blocks on a mesh, with the system, grid,
    ring width, the working dtype, the heads' elevation field in that dtype
    and whether x is signed psi (the fast path) or total head.
    ``dot_part(a, b)`` and ``norm_part(z, x)`` give a dot's and the
    psi-weighted mean norm's per-block partials, ``dot_of`` and ``norm_of``
    their value from the combined total, so that one join combines several
    (:func:`cg_start`, :func:`cg_iteration`)."""
    system: W.LinearSystem
    grid: Grid
    ring: int
    dtype: torch.dtype
    z_field: torch.Tensor
    precond: Callable
    mdot: Callable
    psi_form: bool
    dot_part: Callable
    norm_part: Callable
    dot_of: Callable
    norm_of: Callable


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

    def norm_part(z, x):
        return bmap(weight_sum, grid, z_field, z, x)

    def norm_of(total):
        return total / n_nodes

    def dot_sum(g, d, a, b):
        return owned(torch.where(g.mask, d * a * b, 0.0), ring).sum(
            dtype=torch.float64)

    def dot_part(a, b):
        return bmap(dot_sum, grid, diag, a, b)

    def dot_of(total):
        return total.to(dt)

    def mdot(a, b):
        # <a, b>_D: products in the working dtype, summed in float64 (the
        # balance gate's precision), cast back
        return dot_of(block_sum(dot_part(a, b)))

    return CGOperators(system, grid, ring, dt, z_field, precond, mdot, psi_form,
                       dot_part, norm_part, dot_of, norm_of)


def cg_start(ops: CGOperators, x_init):
    """The solve's start from ``x_init``: ``(s, p, rho, norm0)``, the scaled
    residual, the first direction, r . M^-1 r and the residual's norm."""
    s = bmap(lambda sy, g, x: torch.where(
        g.mask, sy.b + W.stencil_apply(sy, x) - x, 0.0), ops.system, ops.grid, x_init)
    p = ops.precond(s)
    # the dot and the norm in one join
    _, rho, norm0 = combine(sums=(ops.dot_part(s, p), ops.norm_part(s, x_init)))
    return s, p, ops.dot_of(rho), ops.norm_of(norm0)


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
    # r . M^-1 r and the norm in one join
    _, rho_new, norm = combine(sums=(ops.dot_part(s, z), ops.norm_part(s, x)))
    rho_new, norm = ops.dot_of(rho_new), ops.norm_of(norm)
    beta = rho_new / torch.where(rho != 0.0, rho, 1.0)
    p = bmap(lambda z, p: z + beta.to(z.device) * p, z, p)
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
    would drift from JAX's. This standalone solve of one system reads the
    done/diverged flags together once per iteration through ``host_read``;
    the water step's machine runs the same :func:`cg_start`,
    :func:`cg_iteration` and :func:`cg_clamp` as its units, with the flags
    kept on the device.

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

    return cg_clamp(ops, x), diverged, it


def cg_clamp(ops: CGOperators, x):
    """The surface clamp once on CG's solution (JacobiWaterCPU applies it
    per sweep, water.cpp:583-585; the lineal path not at all): floor 0 in
    psi form, z[0] in head form; then the mask. It runs on the rings too."""
    def clamp(g, zf, x):
        floor0 = torch.zeros_like(zf[0]) if ops.psi_form else zf[0]
        x = x.clone()
        x[0] = torch.maximum(x[0], floor0)
        return torch.where(g.mask, x, 0.0)
    return bmap(clamp, ops.grid, ops.z_field, x)


def _decimal_floor_dt(dt: torch.Tensor) -> torch.Tensor:
    """Floor dt at its first significant decimal digit (checkCourant,
    cpusolver.cpp:262-277), on the device: multiply by 10 until >= 1, floor,
    scale back. The loop is bounded at :data:`FLOOR_DT_PASSES` passes, and
    the scale is multiplied by 10 with v, so the powers of 10 stay exact up
    to 1e22 as JAX's ``10.0 ** n`` is; past the bound the floor is 0, which
    the step's ``max(delta_t_min, .)`` turns into delta_t_min, as it turns
    the exact value of so small a dt. The scale-back is the floor times the
    scale's reciprocal, as XLA:CPU evaluates JAX's ``floor(v) / 10.0 ** n``
    (3 x 0.1, not 3 / 10: an ulp apart in ~11% of values)."""
    v, scale = dt, torch.ones_like(dt)
    for _ in range(FLOOR_DT_PASSES):
        below = v < 1.0
        v = torch.where(below, v * 10.0, v)
        scale = torch.where(below, scale * 10.0, scale)
    return torch.floor(v) * torch.reciprocal(scale)


def restore_best_step(grid: Grid, params: SolverParameters,
                      h_r: torch.Tensor, h_old: torch.Tensor,
                      sink_source: torch.Tensor, pond: torch.Tensor,
                      prev_storage: torch.Tensor, dt, approx,
                      boundary_flux_fn=None):
    """restoreBestStep (water.cpp:253-267): saturation, conductivity,
    boundary flows and balance of the best iterate ``h_r``, without the
    linear system; returns ``(h_r, se_r, k_r, flow_r, rate_r, balance)``.

    On the fast path ``h_r``/``h_old`` are float32 psi and the fused
    assembly recomputes flows and k (its stencil is discarded); on the
    float64 path capacity, boundary flows and balance are recomputed.
    ``dt`` and ``approx`` are numbers or 0-d tensors. ``boundary_flux_fn``
    (the heat-coupling boundary hook; on a mesh a Blocked of per-block
    closures) joins the flows on either path. Restores are rare:
    ``restore_best_step.count`` counts them (reset it to 0 before a run;
    under the graph driver the count is kept on the card and added after
    the period; on a mesh run by several machines, the machine holding
    block (0, 0) counts)."""
    if holds_home(grid):
        tally(restore_best_step, "count", _home(grid))

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
             prev_storage, dt) -> tuple:
    """(storage, sink, MBE, MBR) of the domain: the blocks' sums over
    their owned cells combined on the home device."""
    sums = W.mass_balance_sums_psi if _is_fast(params) else W.mass_balance_sums
    ring = _ring(grid)
    surf, soil, flow = unzip(bmap(lambda g, h, se, wf: sums(g, params, h, se, wf, ring),
                                  grid, h, se, water_flow))
    _, surf, soil, flow = combine(sums=(surf, soil, flow))
    return W.balance_from_sums(params, surf, soil, flow, prev_storage, dt)


def _assemble(g: Grid, params: SolverParameters, h, h_old, se, sink_source,
              pond, approx, dt, extra_flux_fn, boundary_flux_fn, out=None):
    """One block's (system, water_flow, boundary_rate, k) of a Picard
    iteration: the fused float32 psi-form pass on the fast path, else
    capacity + boundary flows + assemble_system, each with the hooks;
    in ``out`` (``assemble_fast``'s) when given: the card's kernels write
    into it, any other result is copied there."""
    if _is_fast(params):
        # one fused float32 psi-form pass (capacity + boundary + stencil)
        result = W.assemble_fast(g, params, h, h_old, se, sink_source, pond,
                                 approx, dt, extra_flux_fn=extra_flux_fn,
                                 boundary_flux_fn=boundary_flux_fn, out=out)
    else:
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
        result = system, flow, rate, k
    if out is None or result[3] is out[3]:
        return result
    system = result[0]
    for dst, src in zip((*out[0][:5], *out[1:]), (*system[:5], *result[1:])):
        dst.copy_(src)
    return out[0]._replace(courant=system.courant), *out[1:]


def _link_flows(grid: Grid, params: SolverParameters, h_n: torch.Tensor,
                a_up: torch.Tensor, a_lat: torch.Tensor, dt) -> torch.Tensor:
    """Per-link flows [m3] of an accepted step, (10, L, R, C): up, down and
    the 8 lateral links, positive = inflow to the node (linkData
    waterFlowSum, water.cpp:269-277, with physical conductances). The psi
    form adds the static per-link dz (vert_dist, dz_lat) to its head
    differences and is summed in float64, as JAX's promotion by the float64
    dt does; the float64 form differences total heads. ``dt`` is a number
    or a 0-d tensor. On a block the flows are exact on all but its outer
    cell (the heads' rings are fresh)."""
    dt = scalar(dt, params.dtype, h_n.device)
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
# the machine: the period, step-retry, Picard and inner loops flattened
# ----------------------------------------------------------------------

# int64 scalars: the status (the phase, the period's stats and the counts
# kept on the card), what a driver reads, then the others
_STATUS = ("phase", "steps", "attempts", "approximations", "sweeps", "launches",
           "restores", "assemble_launches")
_INTS = (
    # the attempt (_ApproxCarry) and the inner solve
    "approx", "result", "n_sweeps", "it", "max_iter", "done", "diverged",
    # the phases that follow the evaluation (after the guarded units:
    # ``then`` after the best iterate, ``after`` after the restore), the
    # attempt's end (``end_next``, :meth:`_Machine._set_end_next`) and the
    # step's end (``step_next``, set at the attempt's start), and the
    # phase after a ring refresh of per-sweep Jacobi's x (``x_next``)
    "then", "after", "end_next", "step_next", "x_next")
# scalars of the state dtype: the period (t, its length), the step's dt,
# the attempt's dt_curr, courant, best MBR and balance, and the state's own
_REALS = ("t", "period", "dt", "dt_curr", "courant", "best_mbr",
          "storage", "sink", "mbe", "mbr",
          "st_dt_curr", "st_courant",
          "prev_storage", "prev_sink", "prev_mbe", "prev_mbr",
          "cur_storage", "cur_sink", "cur_mbe", "cur_mbr",
          "per_storage", "per_sink", "per_mbe", "per_mbr")
# the inner solve's scalars, in its working dtype
_SOLVE = ("best", "rho", "tol", "n_nodes")


def _copy(dst, src) -> None:
    """Write ``src`` into the buffer ``dst`` (block into block)."""
    bmap(lambda d, s: d.copy_(s), dst, src)


def _empty(like, dtype=None, lead: tuple = ()):
    return bmap(lambda t: torch.empty(lead + tuple(t.shape), dtype=dtype or t.dtype,
                                      device=t.device), like)


def _clone(t):
    return bmap(torch.clone, t)


class _Machine:
    """The water period as one state machine of units over buffers.

    Every value a unit hands to a later unit lives in a buffer made here:
    the state's fields and 0-d values, the attempt's carry, the assembled
    system, the inner solver's vectors and the scalars
    (:class:`~criteria3d_tpu_torch.solver.device_loop.Slots`).
    A unit reads buffers and writes its results into them (``copy_``), so a
    CUDA graph of the unit replays on the same addresses; a unit never
    reads a device value on the host. ``units()`` maps each phase code to
    its unit, ``follows()`` names what follows a unit that decides nothing
    from data; ``status`` is what the graph driver reads after each launch,
    ``i.buffer`` what the eager driver reads after each unit that decides.
    ``one_step`` ends the machine after one step (JAX's ``compute_step``),
    else it runs until the period is covered; ``step_end``, when given, is
    the phase every step hands on to instead (a larger machine's unit,
    solver/coupled.py's). The slots' names are the class's ``STATUS``,
    ``INTS``, ``REALS`` (the state dtype) and ``SOLVE`` (the working
    dtype), which a larger machine extends."""

    DONE = DONE
    STATUS, INTS, REALS, SOLVE = _STATUS, _INTS, _REALS, _SOLVE

    def __init__(self, grid, params: SolverParameters, state: WaterState,
                 one_step: bool, extra_flux_fn=None, boundary_flux_fn=None,
                 step_end: int | None = None):
        self.grid, self.params, self.one_step = grid, params, one_step
        self.step_end = step_end
        self.xf, self.bf = extra_flux_fn, boundary_flux_fn
        self.fast = fast = _is_fast(params)
        self.home = home = _home(grid)
        self.ring = _ring(grid)
        self.cg = params.inner_solver == "cg"
        self.bundle = (not self.cg) and fast and params.use_pallas
        self.track = params.track_link_flow
        # per-sweep Jacobi on a mesh refreshes x's rings in a unit of its own
        # (X_EXCHANGE), every RING sweeps and at the solve's end
        self.exchanges = bool(self.ring) and not self.cg and not self.bundle
        wd = params.sweep_dtype if fast else params.dtype
        self.wd = wd
        if fast:
            # the float32 casts the assembly reads, made here and not inside
            # a capture (Grid.astype keeps them with the grid)
            bmap(lambda g: g.astype(wd), grid)

        self.i = device_loop.Slots(self.STATUS + self.INTS, torch.int64, home)
        self.r = device_loop.Slots(self.REALS, params.dtype, home)
        self.w = device_loop.Slots(self.SOLVE, wd, home)
        self.status = self.i.buffer[:len(self.STATUS)]
        tol = params.residual_tolerance
        self.w.tol.fill_(max(tol, 1e-7) if fast else tol)
        self.w.n_nodes.fill_(float(first_block(grid).n_nodes))
        self.max_iter_of = torch.tensor(
            [params.max_iterations_for(a) for a in range(params.max_approximations)],
            dtype=torch.int64, device=home)

        # the state
        h = state.h
        self.h, self.h_old, self.best_h, self.se, self.k = (
            _empty(h) for _ in range(5))
        self.bflow = _empty(state.boundary_flow_sum)
        self.lflow = _empty(state.link_flow_sum) if self.track else None
        self.sink_source, self.pond = _empty(state.sink_source), _empty(state.pond)
        # the attempt: its iterate, saturation, conductivity, flows, best
        # iterate, and on the fast path its psi seed (the attempt's h_old)
        (self.c_h, self.c_se, self.c_k, self.c_flow, self.c_rate,
         self.c_best) = (_empty(h, wd) for _ in range(6))
        self.psi_old = _empty(h, wd) if fast else None
        if self.track:
            self.a_up, self.a_lat = _empty(h, wd), _empty(h, wd, (8,))
        # the assembled system and the inner solver's vectors
        self.system = bmap(lambda b, cu, cd, cl, dg: W.LinearSystem(b, cu, cd, cl, dg, None),
                           _empty(h, wd), _empty(h, wd), _empty(h, wd),
                           _empty(h, wd, (8,)), _empty(h, wd))
        self.x = _empty(h, wd)
        if self.cg:
            self.s, self.p = _empty(h, wd), _empty(h, wd)
            self.ops = cg_operators(self.system, grid, params, fast, wd)
        if self.bundle:
            self.mask_f = bmap(lambda g: g.mask.to(wd), grid)
            self.arrays = (*(bmap(lambda sy, k=k: sy[k], self.system) for k in range(4)),
                           self.mask_f)

    # -- what a driver needs ------------------------------------------------

    def units(self) -> dict:
        """Phase code -> (name, unit) of every unit this configuration runs."""
        units = {START: self._start, ASSEMBLE: self._assemble,
                 COURANT_CUT: self._courant_cut, SOLVE_INIT: self._solve_init,
                 SOLVE: self._solve, SOLVE_END: self._solve_end,
                 EVALUATE: self._evaluate, STORE_BEST: self._store_best,
                 RESTORE: self._restore, ATTEMPT_END: self._attempt_end,
                 ACCEPT: self._accept, HALVE: self._halve}
        if self.exchanges:
            units[X_EXCHANGE] = self._x_exchange
        return {code: (fn.__name__.lstrip("_"), fn) for code, fn in units.items()}

    def follows(self) -> dict:
        """Phase code -> what follows that unit, for each unit whose next
        phase does not depend on data it computes: a phase code, or the
        name of the int slot that an earlier unit set and the eager
        driver's last read holds. The eager driver reads the host after the
        other units only."""
        # the Courant cut and a halving set ``end_next``, so the driver
        # reads after them (both are rare)
        follows = {START: ASSEMBLE, SOLVE_END: EVALUATE, STORE_BEST: "then",
                   RESTORE: "after", ATTEMPT_END: "end_next", ACCEPT: "step_next"}
        if not self.cg:
            follows[SOLVE_INIT] = SOLVE
        if self.exchanges:
            follows[X_EXCHANGE] = "x_next"
        return follows

    def tallies(self) -> list:
        """(function, attribute, status slot) of the counts a capture keeps
        on the card."""
        return [(jacobi_bundle, "launches", self.i.index["launches"]),
                (restore_best_step, "count", self.i.index["restores"]),
                (W.assemble_fast, "launches", self.i.index["assemble_launches"])]

    def prepare_capture(self) -> None:
        """What must exist before a capture: the kernel libraries, loaded."""
        if self.bundle:
            _bundle_library()
        if self.fast:
            _assemble_library()

    def join_like(self):
        """A block of the one field the machine's joins exchange (x, and
        CG's p, which is shaped and typed as x)."""
        return first_block(self.x)

    def load(self, state: WaterState, period: float, start: float) -> None:
        """Copy a period's inputs into the buffers and set the carries to
        the period's start."""
        for dst, src in ((self.h, state.h), (self.h_old, state.h_old),
                         (self.best_h, state.best_h), (self.se, state.se),
                         (self.k, state.k), (self.bflow, state.boundary_flow_sum),
                         (self.sink_source, state.sink_source), (self.pond, state.pond)):
            _copy(dst, src)
        if self.track:
            _copy(self.lflow, state.link_flow_sum)
        b = (state.balance_prev, state.balance_current, state.balance_period)
        self.r.span("st_dt_curr", 14).copy_(torch.stack(
            [state.dt_curr, state.courant]
            + [getattr(x, f) for x in b for f in ("storage", "sink_source", "mbe", "mbr")]
        ).to(self.home))
        self.r.t.fill_(start)
        self.r.period.fill_(period)
        self.i.buffer.zero_()
        # the first phase, known on the host
        self.first_phase = START if self.one_step or start < period else DONE
        self.i.phase.fill_(self.first_phase)

    def state_out(self, state: WaterState) -> WaterState:
        """The machine's state as a new WaterState (copies of the buffers);
        the inputs it does not change are ``state``'s."""
        r = self.r

        def bal(prefix):
            return BalanceData(*(getattr(r, prefix + f).clone()
                                 for f in ("storage", "sink", "mbe", "mbr")))
        return dataclasses.replace(
            state, h=_clone(self.h), h_old=_clone(self.h_old),
            best_h=_clone(self.best_h), se=_clone(self.se), k=_clone(self.k),
            boundary_flow_sum=_clone(self.bflow),
            link_flow_sum=_clone(self.lflow) if self.track else state.link_flow_sum,
            dt_curr=r.st_dt_curr.clone(), courant=r.st_courant.clone(),
            balance_prev=bal("prev_"), balance_current=bal("cur_"),
            balance_period=bal("per_"))

    # -- the units ----------------------------------------------------------

    def _h_old(self):
        """The attempt's h_old: the psi seed on the fast path, the state's
        heads on the float64 one."""
        return self.psi_old if self.fast else self.h

    def _start(self):
        """An attempt's start (JAX's _compute_step body, :560-584, and the
        _ApproxCarry it starts from, :470-478)."""
        g, p, i, r = self.grid, self.params, self.i, self.r
        r.dt.copy_(torch.minimum(r.st_dt_curr, r.period - r.t))
        # the phase after the step's end: the period goes on while t + dt
        # < period (one step only with ``one_step``; ``step_end`` names it)
        if self.step_end is not None:
            i.step_next.fill_(self.step_end)
        elif self.one_step:
            i.step_next.fill_(DONE)
        else:
            i.step_next.copy_(torch.where(r.t + r.dt < r.period, START, DONE))
        if self.fast:
            # psi-carry: ONE f64 subtraction per attempt, then the whole
            # Picard loop runs in f32 signed psi
            _copy(self.psi_old, bmap(lambda g, h: torch.where(
                g.mask, h - g.z, 0.0).to(self.wd), g, self.h))
            se = bmap(lambda g, x: W.compute_se_psi(g, p, x), g, self.psi_old)
        else:
            se = bmap(lambda g, h: W.compute_se(g, p, h), g, self.h)
        _copy(self.c_h, self._h_old())
        _copy(self.c_se, se)
        _copy(self.c_best, self._h_old())
        for f in (self.c_k, self.c_flow, self.c_rate) + (
                (self.a_up, self.a_lat) if self.track else ()):
            bmap(torch.Tensor.zero_, f)
        i.approx.zero_()
        i.result.fill_(RUNNING)
        i.n_sweeps.zero_()
        r.dt_curr.copy_(r.st_dt_curr)
        r.best_mbr.fill_(math.inf)
        r.courant.zero_()
        r.span("storage", 4).zero_()
        i.phase.fill_(ASSEMBLE)

    def _assemble(self):
        """Assembly of a Picard iteration and checkCourant's test
        (JAX :430-454); the iteration's k, flows and Courant number go to the
        carry, as every branch after it takes them."""
        g, p, i, r = self.grid, self.params, self.i, self.r
        with torch.profiler.record_function(ASSEMBLE_RANGE):
            courant = bmap(
                lambda g, h, ho, se, sk, pd, xf, bf, sy, fl, rt, k: _assemble(
                    g, p, h, ho, se, sk, pd, i.approx, r.dt, xf, bf,
                    out=(sy, fl, rt, k))[0].courant,
                g, self.c_h, self._h_old(), self.c_se, self.sink_source, self.pond,
                self.xf, self.bf, self.system, self.c_flow, self.c_rate, self.c_k)
        r.courant.copy_(block_max(courant))
        fail = (r.courant >= 1.01) & (r.dt > p.delta_t_min)
        i.phase.copy_(torch.where(fail, COURANT_CUT, SOLVE_INIT))

    def _courant_cut(self):
        """checkCourant (cpusolver.cpp:248-281; JAX :455-462)."""
        i, r = self.i, self.r
        r.dt_curr.copy_(torch.clamp_min(_decimal_floor_dt(r.dt_curr / r.courant),
                                        self.params.delta_t_min))
        i.result.fill_(HALVED)
        i.approx.add_(1)
        self._set_end_next()
        i.phase.fill_(ATTEMPT_END)

    def _solve_init(self):
        """The inner solve's start (JAX :100-133, :186-222,
        pallas_jacobi.py:247-253): its iteration cap
        max(25, (approx+1)*maxIter/maxApprox), x = the iterate; CG's first
        residual, direction, rho, best norm and no-iteration stop."""
        i, w = self.i, self.w
        with torch.profiler.record_function(SOLVE_RANGE):
            i.max_iter.copy_(self.max_iter_of.index_select(0, i.approx.view(1))[0])
            i.it.zero_()
            i.done.zero_()
            i.diverged.zero_()
            _copy(self.x, self.c_h)
            if self.cg:
                s, pp, rho, norm0 = cg_start(self.ops, self.x)
                _copy(self.s, s)
                _copy(self.p, pp)
                w.rho.copy_(rho)
                w.best.copy_(torch.maximum(norm0, w.tol))
                i.done.copy_(norm0 < w.tol)
                # max_iter >= 25: the first iteration runs unless converged
                i.phase.copy_(torch.where(i.done != 0, SOLVE_END, SOLVE))
            else:
                w.best.fill_(1.0)
                i.phase.fill_(SOLVE)

    def _solve(self):
        """One iteration of the inner solve: a CG iteration, a per-sweep
        Jacobi sweep or one bundle of K sweeps, with its stop test."""
        g, i, w = self.grid, self.i, self.w
        with torch.profiler.record_function(SOLVE_RANGE):
            if self.cg:
                x, s, pp, rho, best, converged, div = cg_iteration(
                    self.ops, self.x, self.s, self.p, w.rho, w.best, w.tol)
                _copy(self.s, s)
                _copy(self.p, pp)
                w.rho.copy_(rho)
                n = 1
            else:
                if self.bundle:
                    x, total = (mesh_bundle(self.arrays, self.x) if self.ring
                                else jacobi_bundle(*self.arrays, self.x))
                    n = SWEEPS_PER_BUNDLE
                else:
                    sweep = W.jacobi_sweep_psi_sum if self.fast else W.jacobi_sweep_sum
                    x, total = unzip(bmap(lambda sy, xb, g: sweep(sy, xb, g, self.ring),
                                          self.system, self.x, g))
                    total = block_sum(total)
                    n = 1
                # the comparisons in the sweep dtype, as in JAX
                converged, div, best = sweep_test(total / w.n_nodes, w.tol, w.best)
            _copy(self.x, x)
            w.best.copy_(best)
            i.it.add_(n)
            done = converged | div
            i.done.copy_(done)
            i.diverged.copy_(div)
            # a divergence halves dt where dt can halve (JAX :463-470)
            halve = div & (self.r.dt > self.params.delta_t_min)
            nxt = torch.where(~done & (i.it < i.max_iter), SOLVE,
                              torch.where(halve, HALVE, SOLVE_END))
            if self.exchanges:
                # a sweep leaves the outer cell of a block stale, so the
                # owned cells stay exact for RING sweeps between refreshes;
                # the solve's end needs fresh rings too
                i.x_next.copy_(nxt)
                nxt = torch.where((torch.remainder(i.it, self.ring) == 0)
                                  | (nxt == SOLVE_END), X_EXCHANGE, nxt)
            i.phase.copy_(nxt)

    def _x_exchange(self):
        """Per-sweep Jacobi's ring refresh on a mesh: x with fresh rings,
        then ``x_next``, the phase the sweep's test chose."""
        with torch.profiler.record_function(SOLVE_RANGE):
            _copy(self.x, exchange(self.x))
        self.i.phase.copy_(self.i.x_next)

    def _halve(self):
        """A divergence that halves dt (JAX :463-470): the sweeps, the
        HALVED result, dt_curr / 2 and the approximation counted; the
        attempt ends and reads nothing of the solve."""
        i, r = self.i, self.r
        i.n_sweeps.add_(i.it)
        i.result.fill_(HALVED)
        r.dt_curr.copy_(torch.clamp_min(r.dt_curr / 2.0, self.params.delta_t_min))
        i.approx.add_(1)
        self._set_end_next()
        i.phase.fill_(ATTEMPT_END)

    def _solve_end(self):
        """The solve's end (JAX :471-505): CG's surface clamp, the sweeps
        and the iterate's update (x, se, the physical conductances)."""
        g, p, i = self.grid, self.params, self.i
        with torch.profiler.record_function(SOLVE_RANGE):
            x = cg_clamp(self.ops, self.x) if self.cg else self.x
        i.n_sweeps.add_(i.it)
        _copy(self.c_h, x)
        se_fn = W.compute_se_psi if self.fast else W.compute_se
        _copy(self.c_se, bmap(lambda g, xb: se_fn(g, p, xb), g, self.c_h))
        if self.track:
            # physical conductances from the preconditioned stencil
            # (updateLinkFlux analogue, water.cpp:269-277)
            _copy(self.a_up, bmap(lambda sy: sy.c_up * sy.diag, self.system))
            _copy(self.a_lat, bmap(lambda sy: sy.c_lat * sy.diag[None], self.system))
        i.phase.fill_(EVALUATE)

    def _evaluate(self):
        """evaluateWaterBalance (water.cpp:165-227) and the accept / halve /
        restore / grow decision (JAX's evaluate, :300-372), into the carry;
        the best iterate and the restore follow as units of their own."""
        g, p, i, r = self.grid, self.params, self.i, self.r
        storage, sink, mbe, mbr = _balance(g, p, self.c_h, self.c_se, self.c_flow,
                                           r.prev_storage, r.dt)
        approx = i.approx
        err = torch.abs(mbr)
        is_nan = ~torch.isfinite(err)
        can_halve = r.dt > p.delta_t_min
        ok = ~is_nan & (err < p.mbr_threshold)
        # best-step tracking (before the instability check)
        store_best = ~is_nan & ~ok & ((approx == 0) | (err < r.best_mbr))
        r.best_mbr.copy_(torch.where(store_best, err, r.best_mbr))
        unstable = ~is_nan & ~ok & ((err > r.best_mbr * p.instability_factor)
                                    | (approx == p.max_approximations - 1))
        halved = (is_nan & can_halve) | (unstable & can_halve)
        restore = (is_nan & ~can_halve & (approx > 0)) | (unstable & ~can_halve)
        fatal_nan = is_nan & ~can_halve & (approx == 0)
        accepted = ok | restore
        # a refused balance keeps the Picard loop RUNNING
        result = torch.where(accepted, ACCEPTED, torch.where(
            halved, HALVED, torch.where(fatal_nan, NAN, RUNNING)))
        grow = (ok & (approx < 3) & (err < p.mbr_threshold * 0.1)
                & (r.courant < p.courant_threshold))
        r.dt_curr.copy_(torch.where(
            halved, torch.clamp_min(r.dt_curr * 0.5, p.delta_t_min),
            torch.where(grow, torch.clamp_max(r.dt_curr * 2.0, p.delta_t_max),
                        r.dt_curr)))
        r.span("storage", 4).copy_(torch.stack([storage, sink, mbe, mbr]))
        i.result.copy_(result)
        i.approx.add_(1)
        self._set_end_next()
        # the Picard loop's test, after the guarded units
        after = torch.where((result == RUNNING) & (i.approx < p.max_approximations),
                            ASSEMBLE, ATTEMPT_END)
        then = torch.where(restore, RESTORE, after)
        i.after.copy_(after)
        i.then.copy_(then)
        i.phase.copy_(torch.where(store_best, STORE_BEST, then))

    def _store_best(self):
        """The best iterate so far (JAX's ``best_h`` select, :318)."""
        _copy(self.c_best, self.c_h)
        self.i.phase.copy_(self.i.then)

    def _restore(self):
        """restoreBestStep (JAX's ``lax.cond`` at :375) of the attempt's
        best iterate, with the iteration's approx (the carry's is one past
        it)."""
        i, r = self.i, self.r
        _, se_r, k_r, flow_r, rate_r, bal = restore_best_step(
            self.grid, self.params, self.c_best, self._h_old(), self.sink_source,
            self.pond, r.prev_storage, r.dt, i.approx - 1, self.bf)
        _copy(self.c_h, self.c_best)
        _copy(self.c_se, se_r)
        _copy(self.c_k, k_r)
        _copy(self.c_flow, flow_r)
        _copy(self.c_rate, rate_r)
        r.span("storage", 4).copy_(torch.stack(list(bal)))
        i.phase.copy_(i.after)

    def _to_head(self, x):
        return bmap(lambda g, x: torch.where(g.mask, g.z + x.to(self.params.dtype), 0.0),
                    self.grid, x)

    def _fatal(self):
        """The attempt's result ends the step unaccepted: NaN, or a RUNNING
        leak, treated as fatal as in JAX."""
        return (self.i.result == NAN) | (self.i.result == RUNNING)

    def _set_end_next(self):
        """The phase after the attempt's end, from its result: accept, end
        the step (fatal: then ``step_next``) or retry."""
        i = self.i
        i.end_next.copy_(torch.where(i.result == ACCEPTED, ACCEPT,
                                     torch.where(self._fatal(), i.step_next, START)))

    def _attempt_end(self):
        """The attempt's end (JAX's _compute_step body after the Picard
        loop, :586-655): the state's best iterate, dt_curr, Courant number
        and current balance whether or not it was accepted, the counts;
        then ``end_next``: accept, retry, or end the step (:meth:`_fatal`:
        t advances by dt and the step is counted)."""
        i, r = self.i, self.r
        fatal = self._fatal()
        _copy(self.best_h, self._to_head(self.c_best) if self.fast else self.c_best)
        r.st_dt_curr.copy_(r.dt_curr)
        r.st_courant.copy_(r.courant)
        r.span("cur_storage", 4).copy_(r.span("storage", 4))
        i.attempts.add_(1)
        i.approximations.add_(i.approx)
        i.sweeps.add_(i.n_sweeps)
        r.t.copy_(torch.where(fatal, r.t + r.dt, r.t))
        i.steps.add_(fatal.to(torch.int64))
        i.phase.copy_(i.end_next)

    def _accept(self):
        """acceptStep (water.cpp:230-251; JAX :600-650): on the fast path
        the f64 state is reconstructed once here."""
        g, p, r = self.grid, self.params, self.r
        dtype = p.dtype
        _copy(self.h_old, self.h)
        _copy(self.h, self._to_head(self.c_h) if self.fast else self.c_h)
        _copy(self.se, self.c_se)
        _copy(self.k, self.c_k)
        _copy(self.bflow, bmap(lambda b, rt: b + rt.to(dtype) * scalar(r.dt, dtype, b.device),
                               self.bflow, self.c_rate))
        if self.track:
            # link_flow_sum changes only on accepted steps
            _copy(self.lflow, bmap(lambda g, lf, h, au, al: lf + _link_flows(
                g, p, h, au, al, r.dt), g, self.lflow, self.c_h, self.a_up, self.a_lat))
        r.span("prev_storage", 2).copy_(r.span("storage", 2))
        r.per_sink.copy_(r.per_sink + r.sink)
        r.t.copy_(r.t + r.dt)
        self.i.steps.add_(1)
        self.i.phase.copy_(self.i.step_next)


# ----------------------------------------------------------------------
# the public API
# ----------------------------------------------------------------------

def _run(grid, params: SolverParameters, state: WaterState, period: float,
         start: float, one_step: bool, extra_flux_fn=None, boundary_flux_fn=None):
    """The machine driven over one period (or one step): ``(machine,
    status)``, status the driver's last read (phase, steps, attempts,
    approximations, inner iterations, ...)."""
    check_supported(params)
    _check_blocks(grid, params, state)
    # what a kept graph machine was captured for: the grid and the hooks
    # (the machine holds them, so their ids stay their own), the
    # parameters, the mode and the state's shapes
    key = ("water", id(grid), id(extra_flux_fn), id(boundary_flux_fn), params,
           one_step, shapes_of(state))
    m, status = device_loop.run_period(
        key, lambda blocks=None: _Machine(part(grid, blocks), params, part(state, blocks),
                                          one_step, part(extra_flux_fn, blocks),
                                          part(boundary_flux_fn, blocks)),
        lambda m: m.load(state, period, start), _home(grid), params.mesh)
    return (_merged(m) if isinstance(m, list) else m), status


def _merged(machines: list):
    """The machines of one mesh's rounds as one machine for reading their
    result: every blocked buffer joined from the machines' parts, the
    scalars the first machine's (the machines hold equal ones)."""
    out = object.__new__(type(machines[0]))
    out.__dict__.update(machines[0].__dict__)
    for name, v in vars(machines[0]).items():
        if isinstance(v, Blocked):
            setattr(out, name, merge([getattr(m, name) for m in machines]))
    return out


def shapes_of(state) -> tuple:
    """The shapes, dtypes and devices of a state's fields (a dataclass of
    tensors, blocked tensors and 0-d values; a blocked field by its mesh
    and each block's): a part of a kept machine's key."""
    def shape(v):
        if isinstance(v, torch.Tensor):
            return tuple(v.shape), v.dtype, v.device
        if isinstance(v, Blocked):
            return id(v.mesh), tuple(shape(b) for b in v.blocks.flat)
        return shapes_of(v) if dataclasses.is_dataclass(v) else v
    return tuple(shape(getattr(state, f.name)) for f in dataclasses.fields(state))


@device_loop.period_span()
def _compute_step(grid: Grid, params: SolverParameters, state: WaterState,
                  max_time_step: float, extra_flux_fn=None,
                  boundary_flux_fn=None):
    """Retry attempts until one is accepted (or fails fatally).

    Returns ``(state, dt_accepted, (n_attempts, n_approx, n_sweeps),
    boundary_rate, dt_curr)`` with the host copies of the step and the new
    step size (one host read besides the driver's); ``boundary_rate`` is
    the last assembly's, which the heat boundary of the coupled step
    reads. The heat-coupling hooks go to every Picard iteration:
    ``extra_flux_fn(psi, k)`` (the invariantFluxes mechanism,
    water.cpp:329-341, cpusolver.cpp:388) enters the RHS only;
    ``boundary_flux_fn(psi, dt)`` (the HeatSurface evaporative sink,
    water.cpp:708-747) enters the RHS and the balance, and the restore
    too. They receive SIGNED psi (float32 on the fast path, float64
    otherwise) and ``dt`` as a 0-d tensor of the state dtype. On a mesh
    grid and state are blocked (:func:`_check_blocks`)."""
    m, status = _run(grid, params, state, float(max_time_step), 0.0, True,
                     extra_flux_fn, boundary_flux_fn)
    dt, dt_curr = (float(v) for v in host_array(torch.stack([m.r.dt, m.r.st_dt_curr])))
    rate = bmap(lambda t: t.to(params.dtype, copy=True), m.c_rate)
    return (m.state_out(state), dt, tuple(int(v) for v in status[2:5]), rate, dt_curr)


def compute_step(grid: Grid, params: SolverParameters, state: WaterState,
                 max_time_step):
    """Advance the water state by one adaptive step (<= max_time_step [s]);
    returns ``(new_state, dt_accepted)`` with ``dt_accepted`` a float
    (computeStep, soilFluxes3D.cpp:1785-1821)."""
    st, dt, _, _, _ = _compute_step(grid, params, state, float(max_time_step))
    return st, dt


@device_loop.period_span()
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

    m, status = _run(grid, params, state, period, start, False)
    state = m.state_out(state)

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
    return state, tuple(int(v) for v in status[1:5])


def compute_period(grid: Grid, params: SolverParameters, state: WaterState,
                   period_seconds) -> WaterState:
    """Run adaptive steps until ``period_seconds`` is covered, then close
    the period balance (computePeriod, soilFluxes3D.cpp:1760-1777)."""
    state, _ = compute_period_stats(grid, params, state, period_seconds)
    return state

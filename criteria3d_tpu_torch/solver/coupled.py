"""Coupled water + heat stepping.

PyTorch counterpart of ``criteria3d_tpu/solver/coupled.py`` (computeStep's
heat sub-stepping, soilFluxes3D.cpp:1785-1821, and CPUSolver::run,
cpusolver.cpp:77-91): each accepted water step of length dtWater is covered
by boundary chunks, each with its boundary heat flux and Courant limit
evaluated once (updateBoundaryHeatData, heat.cpp:237-341), and each chunk by
heat sub-steps halved while the heat balance fails (|heatMBR| > 1).

The JAX package runs the period as one ``jax.jit`` over nested
``lax.while_loop``s (the period at coupled.py:259, the chunks capped at
``max_substeps`` at :215, the sub-steps capped at 4096 at :180 and :209,
each heat solve's sweeps at heat.py:1094 and :1298), with ``lax.cond``
rebuilding exact mode's energy cache (:193). Here the whole period is one
state machine, :class:`_CoupledMachine`: the water step's machine
(solver/step.py's ``_Machine``, whose step hands on to the heat units
instead of ending) and the heat units after it, in JAX's order (the step's
start, the water step, its end, a chunk's start, the cache rebuild, a
sub-step's system, a sweep, the sub-step's end, the chunk's end, the step's
end, the period's water balance). Every carry of the nest is a buffer or a
0-d slot on the device (the dts in float64 with JAX's operations in JAX's
order), so solver/device_loop.py drives it like the water machine: as CUDA
graphs on one card, whole or in blocks; in rounds on a mesh whose blocks
several machines run (one a card, or ``make_mesh``'s ``machines``), each
machine over its part of the blocks; unit by unit from Python on the CPU
(a host read after each unit that decides from data). The heat hooks of
the water
step read the machine's buffers (the step's temperatures, conductances and
frozen flux); the HeatBoundary and the heat state are copied into buffers
each period. The counts of a run are in :func:`counts` (reset them with
:func:`reset_counts`).

With ``params.mesh`` grid, water, heat and boundary are cut by
``shard_pytree`` and the whole coupled step runs on the mesh's blocks, as
JAX's GSPMD partitions it: the buffers are blocked, the water step's heat
hooks are per-block closures over each block's buffers, the heat functions
run per block with their sums and maxima combined on ``mesh.home``
(solver/heat.py) and the heat sweeps refresh x's rings every ``RING``
sweeps and at a solve's end, in a unit the phase guards. ``gather_pytree`` joins the result.
Split into machines, each combines every block's partials in the mesh's
row-major order from its ``sharding.Join`` board, so the result is
bit-equal to one machine's; a chunk's Courant maximum and flow sum, and a
sub-step's two storage sums, share a join (one round each), and every
heat sweep keeps its own max-norm join (JAX's per-sweep stop test).
"""

from __future__ import annotations

import dataclasses

import torch

from criteria3d_tpu_torch.core.grid import Grid
from criteria3d_tpu_torch.core.state import (BalanceData, SolverParameters,
                                             WaterState)
from criteria3d_tpu_torch.device import host_read
from criteria3d_tpu_torch.parallel.sharding import (Blocked, blocks_of, bmap, combine,
                                                    exchange, part)
from criteria3d_tpu_torch.solver import device_loop
from criteria3d_tpu_torch.solver import heat as H
from criteria3d_tpu_torch.solver.step import (DONE, START, _check_blocks, _clone,
                                              _empty, _home, _Machine, _merged,
                                              check_supported, shapes_of)

__all__ = ["compute_step_coupled", "compute_period_coupled", "counts",
           "reset_counts"]

# solver effort of the coupled steps since the last reset_counts()
_COUNT_NAMES = ("steps", "attempts", "approximations", "inner_iterations",
                "chunks", "substeps_accepted", "substeps_rejected")

# the coupled units' phases, after the water step's (solver/step.py's)
STEP_START = 14     # the step's frozen conductances (and thermal flux)
WATER_END = 15      # the water step's end: the evaporation rate, the chunk loop's start
CHUNK = 16          # a chunk: boundary flow and dtHeat, invariants, frozen system
REBUILD = 17        # exact mode's energy cache for a new sub-step length
SUBSTEP = 18        # a sub-step's system
SWEEP = 19          # one heat Jacobi sweep and its stop test
SUBSTEP_END = 20    # the balance: accept or halve; the sub-step loop's test
CHUNK_END = 21      # the chunk loop's test
STEP_END = 22       # the step's temperatures for the next step's hooks
PERIOD_END = 23     # the period water balance
H_EXCHANGE = 24     # on a mesh, the heat sweeps' x rings refreshed

# the sub-step loop's cap in a chunk (JAX's coupled.py:169, :188)
SUBSTEPS_PER_CHUNK = 4096


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


def _put(dst, src) -> None:
    """Write ``src`` into the buffers ``dst`` (block into block, a tuple
    item by item); an item that is no tensor, or the buffer itself, is
    left. A result of another shape or dtype raises: a unit hands on only
    what a buffer holds, unconverted."""
    if isinstance(dst, Blocked):
        bmap(_put, dst, src)
    elif isinstance(dst, tuple):
        for d, s in zip(dst, src):
            _put(d, s)
    elif isinstance(dst, torch.Tensor) and dst is not src:
        if dst.shape != src.shape or dst.dtype != src.dtype:
            raise RuntimeError(f"coupled machine: a {src.dtype} {tuple(src.shape)} "
                               f"result for a {dst.dtype} {tuple(dst.shape)} buffer")
        dst.copy_(src)


class _CoupledMachine(_Machine):
    """The coupled period (or step, ``one_step``) as one state machine: the
    water machine's units and buffers, and the heat sub-stepping's
    (module docstring). The heat carries: the temperatures ``T`` (the
    sub-steps' t and t_old), ``T_old`` (the water hooks' t_old: the
    input's in the first step, then ``T``), the chunk's boundary flow, its
    energy invariants or frozen system, a sub-step's preconditioned system
    and sweep iterate, and the 0-d slots of the loops (float64 dts, the
    balance's storage, sink and MBR, int64 counters). The status adds the
    chunks and sub-steps run and the heat sweeps counted on the card."""

    STATUS = _Machine.STATUS + ("chunks", "substeps_accepted", "substeps_rejected",
                                "heat_sweeps")
    INTS = _Machine.INTS + ("chunk_it", "sub_it", "sweep_it", "step_after", "h_next")
    REALS = _Machine.REALS + ("t_sum", "dt_pref", "chunk", "t_in", "dt_h", "dt_try",
                              "cache_dt", "flow_sum", "heat_sp", "heat_sw", "heat_mbr",
                              "whole_storage", "whole_sink", "whole_mbe", "whole_mbr")
    SOLVE = _Machine.SOLVE + ("heat_tol",)

    def __init__(self, grid, params: SolverParameters, water: WaterState,
                 heat: H.HeatState, boundary: H.HeatBoundary, one_step: bool,
                 max_substeps: int):
        super().__init__(grid, params, water, one_step, step_end=WATER_END)
        p, r, wd = params, self.r, self.wd
        self.max_substeps = max_substeps
        self.frozen = params.heat_frozen_props and self.fast
        self.budget = H.sweep_budget(params)
        self.w.heat_tol.fill_(float(H.heat_tolerance(params)))

        # the heat state and the forcing, loaded each period
        self.T, self.T_old, self.heat_sink = (_empty(heat.t), _empty(heat.t_old),
                                              _empty(heat.sink_source))
        self.boundary = H.HeatBoundary(**{
            f.name: _empty(getattr(boundary, f.name)) for f in dataclasses.fields(boundary)})
        # the heat functions' views: inside the sub-stepping t_old is T; the
        # water hooks read T_old
        self.heat = H.HeatState(t=self.T, t_old=self.T, sink_source=self.heat_sink,
                                storage_prev=r.heat_sp, storage_whole=None,
                                sink_whole=r.heat_sw, mbr=r.heat_mbr)
        hook_heat = dataclasses.replace(self.heat, t_old=self.T_old)
        self.water = WaterState(h=self.h, h_old=self.h_old, best_h=self.best_h, se=self.se,
                                k=self.k, sink_source=self.sink_source, pond=self.pond,
                                boundary_flow_sum=self.bflow, link_flow_sum=self.lflow,
                                dt_curr=r.st_dt_curr, courant=r.st_courant,
                                balance_prev=None, balance_current=None,
                                balance_period=None, balance_whole=None)
        # the step's frozen conductances, the water step's evaporation rate
        # and the chunk's boundary flow
        self.aero_k, self.soil_k = (_empty(boundary.air_temperature, p.dtype)
                                    for _ in range(2))
        self.conduct = bmap(lambda a, s: (a, s), self.aero_k, self.soil_k)
        self.evap_rate = (_empty(boundary.air_temperature, p.dtype) if p.heat_vapor
                          else None)
        self.flow = _empty(heat.t, p.dtype)
        self.heat_mask = bmap(H._heat_mask, grid)

        def invariants(t, with_theta: bool):
            # the float64 fields, and exact mode's float32 retentions
            theta = ([torch.empty_like(t, dtype=p.sweep_dtype) for _ in range(4)]
                     if with_theta else [None] * 4)
            return H.SubstepInvariants(
                *(torch.empty_like(t, dtype=p.dtype) for _ in range(3)), *theta)
        if self.frozen:
            # the chunk's frozen factors; the sub-steps read the invariants'
            # float64 fields only
            def frozen_system(t, mask):
                e = (lambda lead=(): torch.empty(lead + tuple(t.shape), dtype=wd,
                                                 device=t.device))
                return H.FrozenChunkSystem(
                    heat_mask=mask, aw_up=e(), aw_down=e(), aw_lat=e((8,)), ae_up=e(),
                    ae_down=e(), ae_lat=e((8,)), adiag=e(), cap=e(), const0=e(),
                    corr_rate=e(), inv=invariants(t, False), flow_sum=r.flow_sum,
                    tol=H.heat_tolerance(p))
            self.fz = bmap(frozen_system, heat.t, self.heat_mask)
            self.tw_frozen = _empty(heat.t, p.dtype)
        else:
            self.cache = bmap(lambda t: invariants(t, self.fast), heat.t)
        # a sub-step's preconditioned system and the sweeps' iterate
        self.hsys = (_empty(heat.t, wd), _empty(heat.t, wd), _empty(heat.t, wd),
                     _empty(heat.t, wd, (8,)), self.heat_mask)
        self.x_heat = _empty(heat.t, wd)

        # the water step's heat hooks, reading the buffers: the thermal
        # water flux (RHS only; frozen: the step-start flux) and, with
        # heat_vapor, the HeatSurface evaporative sink (RHS and balance)
        if self.frozen:
            self.xf = bmap(lambda tw: (lambda psi, k: tw), self.tw_frozen)
        else:
            self.xf = bmap(lambda g, hs: (lambda psi, k: H.thermal_water_flux(
                g, p, hs, psi, k)), grid, blocks_of(hook_heat))
        if p.heat_vapor:
            self.bf = bmap(lambda g, hs, bd, cd: (lambda psi, dt: H.heat_surface_water_sink(
                g, p, hs, bd, psi, dt, conductances=cd)),
                grid, blocks_of(hook_heat), blocks_of(self.boundary), self.conduct)
        self.hook_heat = hook_heat

    # -- what a driver needs ------------------------------------------------

    def units(self) -> dict:
        units = {STEP_START: self._step_start, WATER_END: self._water_end,
                 CHUNK: self._chunk, SUBSTEP: self._substep, SWEEP: self._sweep,
                 SUBSTEP_END: self._substep_end, CHUNK_END: self._chunk_end,
                 STEP_END: self._step_end, PERIOD_END: self._period_end}
        if not self.frozen:
            units[REBUILD] = self._rebuild
        if self.ring:
            units[H_EXCHANGE] = self._h_exchange
        out = super().units()
        out.update({code: (fn.__name__.lstrip("_"), fn) for code, fn in units.items()})
        return out

    def follows(self) -> dict:
        follows = super().follows()
        follows.update({STEP_START: START, REBUILD: SUBSTEP,
                        SUBSTEP: SWEEP if self.budget > 0 else SUBSTEP_END,
                        STEP_END: "step_after", PERIOD_END: DONE})
        if self.ring:
            follows[H_EXCHANGE] = "h_next"
        return follows

    def tallies(self) -> list:
        return super().tallies() + [
            (H.heat_jacobi_solve, "sweeps", self.i.index["heat_sweeps"])]

    def load(self, water: WaterState, heat: H.HeatState, boundary: H.HeatBoundary,
             period: float) -> None:
        """Copy a period's water, heat and forcing into the buffers and set
        the carries to the period's start."""
        super().load(water, period, 0.0)
        for dst, src in ((self.T, heat.t), (self.T_old, heat.t_old),
                         (self.heat_sink, heat.sink_source)):
            _put(dst, src)
        for f in dataclasses.fields(boundary):
            _put(getattr(self.boundary, f.name), getattr(boundary, f.name))
        bw = water.balance_whole
        self.r.span("heat_sp", 3).copy_(torch.stack(
            [heat.storage_prev, heat.sink_whole, heat.mbr]).to(self.home))
        self.r.span("whole_storage", 4).copy_(torch.stack(
            [bw.storage, bw.sink_source, bw.mbe, bw.mbr]).to(self.home))
        # the first phase, known on the host: a period of no length runs no
        # step (JAX's while_loop), one step always runs
        self.first_phase = (STEP_START if self.one_step or period > 0.0
                            else PERIOD_END)
        self.i.phase.fill_(self.first_phase)

    def state_out(self, state: WaterState) -> WaterState:
        r = self.r
        return dataclasses.replace(super().state_out(state), balance_whole=BalanceData(
            *(getattr(r, "whole_" + f).clone() for f in ("storage", "sink", "mbe", "mbr"))))

    def heat_out(self, heat: H.HeatState) -> H.HeatState:
        """The machine's heat state as a new HeatState (copies of the
        buffers); its sink and whole-period storage are ``heat``'s."""
        r = self.r
        return dataclasses.replace(
            heat, t=_clone(self.T), t_old=_clone(self.T_old),
            storage_prev=r.heat_sp.clone(), sink_whole=r.heat_sw.clone(),
            mbr=r.heat_mbr.clone())

    # -- the units ----------------------------------------------------------

    def _step_start(self):
        """The step's start (JAX's compute_step_coupled, :45-73): the
        surface conductances frozen from the step-start state
        (updateConductance, heat.cpp:214-236) and, with
        ``heat_frozen_props``, the thermal water flux from the step-start
        (psi, k) and temperatures."""
        g, p = self.grid, self.params
        _put(self.conduct, H.surface_conductances(g, p, self.hook_heat, self.boundary,
                                                  self.h))
        if self.frozen:
            sd = p.sweep_dtype
            _put(self.tw_frozen, bmap(lambda g, hs, h, k: H.thermal_water_flux(
                g, p, hs, (h - g.z).to(sd), k.to(sd)),
                g, blocks_of(self.hook_heat), self.h, self.k))
        self.i.phase.fill_(START)

    def _chunk_test(self):
        """The chunk loop's test (JAX :129-131): the phase after it."""
        i, r = self.i, self.r
        return torch.where((r.t_sum < r.dt) & (i.chunk_it < self.max_substeps),
                           CHUNK, STEP_END)

    def _water_end(self):
        """The water step's end (JAX :85-92, :215-220): the heat boundary's
        latent flux reads the evaporative rate of the step's last assembly
        (heat.cpp:957-966); the chunk loop's carries; the phase after the
        step (the next step, the period's end, or the end of one step)."""
        i, r, p = self.i, self.r, self.params
        if p.heat_vapor:
            _put(self.evap_rate, bmap(lambda c: c[1].to(p.dtype), self.c_rate))
        r.t_sum.zero_()
        r.dt_pref.copy_(r.dt)
        i.chunk_it.zero_()
        if self.one_step:
            i.step_after.fill_(DONE)
        else:
            i.step_after.copy_(torch.where(r.t < r.period, STEP_START, PERIOD_END))
        i.phase.copy_(self._chunk_test())

    def _substep_next(self):
        """The sub-step loop's test (JAX :167-169, :186-188) and the next
        sub-step's length, ``min(dt_h, chunk - t_in)``; exact mode rebuilds
        the energy cache when that length is not the cache's (JAX's
        ``lax.cond``, :193)."""
        i, r = self.i, self.r
        more = (r.t_in < r.chunk) & (i.sub_it < SUBSTEPS_PER_CHUNK)
        r.dt_try.copy_(torch.minimum(r.dt_h, r.chunk - r.t_in))
        nxt = SUBSTEP if self.frozen else torch.where(r.dt_try != r.cache_dt, REBUILD,
                                                      SUBSTEP)
        i.phase.copy_(torch.where(more, nxt, CHUNK_END))

    def _chunk(self):
        """A boundary chunk's start (JAX :133-165): the boundary heat flow
        and the Courant-limited chunk length from ``min(dt_pref, dtWater -
        t_sum)``, the flow's sum over the heat nodes, the energy invariants
        for the chunk length and, with ``heat_frozen_props``, the chunk's
        frozen system; the sub-step loop's carries."""
        g, p, i, r = self.grid, self.params, self.i, self.r
        with torch.profiler.record_function(H.HEAT_ASSEMBLE_RANGE):
            chunk_max = torch.minimum(r.dt_pref, r.dt - r.t_sum)
            flow, courant, _ = H.boundary_heat_parts(g, p, self.heat, self.boundary,
                                                     self.water, chunk_max, r.dt,
                                                     self.conduct, self.evap_rate)
            _put(self.flow, flow)
            # the Courant maximum and the flow's sum in one join
            _, flow_sum, courant_max = combine(
                sums=(H.masked_parts(self.heat_mask, self.flow),), maxes=(courant,))
            r.chunk.copy_(H.chunk_dt(p, courant_max, chunk_max))
            r.flow_sum.copy_(flow_sum)
            cache = H.energy_invariants(g, p, self.water, r.chunk, r.dt)
            if self.frozen:
                _put(self.fz, H.chunk_frozen_system(g, p, self.T, self.water, r.chunk,
                                                    r.dt, self.flow, r.flow_sum, cache))
            else:
                _put(self.cache, cache)
                r.cache_dt.copy_(r.chunk)
        i.chunks.add_(1)
        r.t_in.zero_()
        r.dt_h.copy_(r.chunk)
        i.sub_it.zero_()
        self._substep_next()

    def _rebuild(self):
        """Exact mode's energy cache for the sub-step length (JAX's
        ``lax.cond`` at :193)."""
        g, p, r = self.grid, self.params, self.r
        with torch.profiler.record_function(H.HEAT_ASSEMBLE_RANGE):
            _put(self.cache, H.energy_invariants(g, p, self.water, r.dt_try, r.dt))
        r.cache_dt.copy_(r.dt_try)
        self.i.phase.fill_(SUBSTEP)

    def _substep(self):
        """A sub-step's preconditioned system and the sweeps' start: the
        frozen system with the sub-step's dt folded in, or exact mode's
        assembly (heat_step's, heat.py:1057-1153)."""
        g, p, r = self.grid, self.params, self.r
        with torch.profiler.record_function(H.HEAT_ASSEMBLE_RANGE):
            if self.frozen:
                b_p, c_up, c_down, c_lat, t0 = H.fold_dt(p, self.fz, self.T, r.dt_try)
            else:
                b_p, c_up, c_down, c_lat, _, t0, _ = H.heat_system(
                    g, p, self.heat, self.water, r.dt_try, r.dt, self.flow, self.cache)
            _put(self.hsys[:4], (b_p, c_up, c_down, c_lat))
            _put(self.x_heat, t0)
        self.i.sweep_it.zero_()
        self.i.phase.fill_(SWEEP if self.budget > 0 else SUBSTEP_END)

    def _sweep(self):
        """One heat Jacobi sweep and the loop's test (JAX's sweep
        ``while_loop``, heat.py:1094 / :1298); on a mesh the phase goes to
        the ring refresh every ``RING`` sweeps and at the loop's end."""
        i, w = self.i, self.w
        with torch.profiler.record_function(H.HEAT_SOLVE_RANGE):
            x, norm = H.heat_sweep(self.hsys, self.x_heat)
            _put(self.x_heat, x)
            i.sweep_it.add_(1)
            nxt = torch.where(H.sweep_goes_on(i.sweep_it, self.budget, norm, w.heat_tol),
                              SWEEP, SUBSTEP_END)
            if self.ring:
                i.h_next.copy_(nxt)
                nxt = torch.where((torch.remainder(i.sweep_it, self.ring) == 0)
                                  | (nxt == SUBSTEP_END), H_EXCHANGE, nxt)
            i.phase.copy_(nxt)

    def _h_exchange(self):
        """The heat sweeps' ring refresh on a mesh: x with fresh rings, then
        ``h_next``, the phase the sweep's test chose."""
        with torch.profiler.record_function(H.HEAT_SOLVE_RANGE):
            _put(self.x_heat, exchange(self.x_heat))
        self.i.phase.copy_(self.i.h_next)

    def _substep_end(self):
        """The sub-step's end (JAX :174-178, :195-207): the temperatures,
        storage and balance; accepted, t_in advances, else dt_h halves; the
        sub-step loop's test."""
        g, p, i, r = self.grid, self.params, self.i, self.r
        x = self.x_heat
        inv = bmap(lambda f: f.inv, self.fz) if self.frozen else self.cache
        t_new, storage, sink, mbr, ok = H.substep_end(
            g, p, x, self.heat_mask, self.T, r.heat_sp, r.flow_sum, r.dt_try, inv)
        t, storage_prev, sink_whole = H.accept_substep(ok, t_new, self.T, storage,
                                                       r.heat_sp, sink, r.heat_sw)
        _put(self.T, t)
        r.span("heat_sp", 3).copy_(torch.stack([storage_prev, sink_whole, mbr]))
        i.substeps_accepted.add_(ok.to(torch.int64))
        i.substeps_rejected.add_((~ok).to(torch.int64))
        r.t_in.copy_(torch.where(ok, r.t_in + r.dt_try, r.t_in))
        r.dt_h.copy_(torch.where(ok, r.dt_h, r.dt_try * 0.5))
        i.sub_it.add_(1)
        self._substep_next()

    def _chunk_end(self):
        """The chunk's end (JAX :184, :213): t_sum, dt_pref and the chunk
        count, then the chunk loop's test."""
        i, r = self.i, self.r
        r.t_sum.copy_(r.t_sum + r.chunk)
        r.dt_pref.copy_(r.chunk)
        i.chunk_it.add_(1)
        i.phase.copy_(self._chunk_test())

    def _step_end(self):
        """The step's end: its temperatures are the next step's t and t_old
        (JAX's ``with_t``); then ``step_after``."""
        _put(self.T_old, self.T)
        self.i.phase.copy_(self.i.step_after)

    def _period_end(self):
        """The period water balance (water.cpp:143-156; JAX :262-277), with
        the JAX coupled period's signed sink in the denominator
        (coupled.py:269, unlike compute_period_stats' |sink|, DEVIATIONS
        #30): reproduced as written."""
        r = self.r
        whole_sink = r.whole_sink + r.per_sink
        d_period = r.cur_storage - r.per_storage
        d_whole = r.cur_storage - r.whole_storage
        per_mbe = d_period - r.per_sink
        whole_mbe = d_whole - whole_sink
        whole_mbr = whole_mbe / torch.clamp_min(whole_sink, 0.001)
        r.per_storage.copy_(r.cur_storage)
        r.per_mbe.copy_(per_mbe)
        r.span("whole_sink", 3).copy_(torch.stack([whole_sink, whole_mbe, whole_mbr]))
        self.i.phase.fill_(DONE)


def _run(grid, params: SolverParameters, water: WaterState, heat: H.HeatState,
         boundary: H.HeatBoundary, period: float, one_step: bool, max_substeps: int):
    """The coupled machine driven over one period (or step); its counts
    added to :func:`counts`. Returns the machine (under the rounds driver
    the machines' parts merged, ``step._merged``)."""
    check_supported(params)
    # what a kept graph machine was captured for: the kind, the grid, the
    # parameters, the mode, the chunk cap and the inputs' shapes
    key = ("coupled", id(grid), params, one_step, max_substeps, shapes_of(water),
           shapes_of(heat), shapes_of(boundary))
    m, status = device_loop.run_period(
        key, lambda blocks=None: _CoupledMachine(
            part(grid, blocks), params, part(water, blocks), part(heat, blocks),
            part(boundary, blocks), one_step, max_substeps),
        lambda m: m.load(water, heat, boundary, period), _home(grid), params.mesh)
    if isinstance(m, list):
        m = _merged(m)
    cnt, idx = compute_step_coupled.counts, m.i.index
    for name, slot in (("steps", "steps"), ("attempts", "attempts"),
                       ("approximations", "approximations"),
                       ("inner_iterations", "sweeps"), ("chunks", "chunks"),
                       ("substeps_accepted", "substeps_accepted"),
                       ("substeps_rejected", "substeps_rejected")):
        cnt[name] += int(status[idx[slot]])
    return m


def compute_step_coupled(grid: Grid, params: SolverParameters,
                         water: WaterState, heat_state: H.HeatState,
                         boundary: H.HeatBoundary, max_time_step,
                         max_substeps: int = 256):
    """One adaptive water step followed by its heat sub-steps; returns
    ``(water', heat', dt_water)`` with ``dt_water`` a float (one host read
    besides the driver's).

    The water step runs with the heat hooks: the thermal water flux
    (RHS only) and, with ``heat_vapor``, the HeatSurface evaporative sink
    (RHS and balance). The heat sub-steps cover the whole water step.
    With ``params.mesh`` grid, water, heat and boundary are cut over it by
    ``shard_pytree`` and the result is blocked (join it with
    ``gather_pytree``); a mesh with whole inputs, blocked inputs without
    one, or a mix raise ``ValueError``."""
    _check_blocks(grid, params, water, heat_state, boundary)
    m = _run(grid, params, water, heat_state, boundary, float(max_time_step), True,
             max_substeps)
    return m.state_out(water), m.heat_out(heat_state), float(host_read(m.r.dt))


compute_step_coupled.counts = dict.fromkeys(_COUNT_NAMES, 0)


def compute_period_coupled(grid: Grid, params: SolverParameters,
                           water: WaterState, heat_state: H.HeatState,
                           boundary: H.HeatBoundary, period,
                           max_substeps: int = 256):
    """Advance coupled water + heat over a whole period (computePeriod with
    computeHeat active, soilFluxes3D.cpp:1760-1821); returns ``(water,
    heat)``, the period water balance closed as the JAX function closes
    it (water.cpp:143-156, the signed sink of coupled.py:269). On a mesh
    the inputs are blocked, as :func:`compute_step_coupled` takes them,
    and the period balance runs on the 0-d scalars on ``mesh.home``."""
    _check_blocks(grid, params, water, heat_state, boundary)
    # reset the period sink/source counter (soilFluxes3D.cpp:1764)
    bp = water.balance_period
    water = dataclasses.replace(water, balance_period=BalanceData(
        bp.storage, torch.zeros_like(bp.sink_source), bp.mbe, bp.mbr))
    m = _run(grid, params, water, heat_state, boundary, float(period), False,
             max_substeps)
    return m.state_out(water), m.heat_out(heat_state)

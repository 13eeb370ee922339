"""The coupled water + heat period's state machine (solver/coupled.py's
``_CoupledMachine``, run by solver/device_loop.py's eager driver on the
CPU) against the JAX package's jitted ``compute_period_coupled``: coupled
storm periods in five forms (float64 with vapor, ``fast_f32`` exact mode,
``heat_frozen_props``, advection, and the bundle form with JAX's Pallas
kernel interpreted), and periods forced down the heat sub-stepping's rare
branches (a halving on |heatMBR| > 1, the accept-as-is at dt <= 10 dtMin,
a Courant-limited chunk, exact mode's energy-cache rebuild, a small
``max_substeps`` cap). The graph driver runs only on the card:
tests/test_torch_cuda.py holds it to this driver there.

Inputs: a 12 x 12 box of ``problems.synthetic_catchment`` (numpy, seed 3;
a disc of 88 valid cells, 7 layers of clay loam), 20 mm/h of rain from
psi -2 m, soil at 288.15 K, every valid layer-1 node a HeatSurface under
air at 291.15 K, 85 % relative humidity, 3 m/s wind (80 or 600 W/m2 net
irradiance), built by the JAX package and carried across with
``convert``.

Tolerances (PERF.md section 2, the coupled rows): float64 h 1e-9 m and T
1e-7 K (XLA:CPU's FMAs and log1p); ``heat_frozen_props`` h 1e-4 m and T
1e-3 K; ``fast_f32`` exact mode h 1e-4 m and T 1.5e-2 K. The exact-mode T
bar is jitted JAX's own float32 spread on these inputs, wider than on
tests/test_torch_coupled.py's 6 x 6 column (5e-3 K there): jitted JAX
against the same JAX functions run op by op (``jax.disable_jit()``) differ
by 1.32e-2 K over the 1800 s period and 8.6e-3 K over the cache-rebuild
case's 1200 s (42 and 24 halvings re-evaluate float32 properties at every
sub-step), the port by 7.9e-3 K and 3.0e-3 K from the op-by-op run and by
the same 1.34e-2 K and 8.6e-3 K from the jitted one (measured on the CPU); still
3 x inside JAX's float32-vs-float64 bar of 0.05 K (tests/test_coupled.py).
Water counts are held to JAX
as tests/test_torch_device_loop.py holds them: every count in float64, in
float32 the steps, attempts and approximations, the inner iterations
within 1 %. The heat counts (chunks, accepted and rejected sub-steps,
sweeps) and the water counts equal those of the host loops this machine
replaced, recorded from commit f376264 on the same inputs
(:data:`HOST_LOOP_COUNTS`).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import criteria3d_tpu as J
from criteria3d_tpu.core.grid import BoundaryType as JBT
from criteria3d_tpu.solver import heat as JH
from criteria3d_tpu.solver.coupled import compute_period_coupled as j_period
from criteria3d_tpu.solver.step import initialize_balance as j_ib
import criteria3d_tpu_torch as T
from criteria3d_tpu_torch import convert
from criteria3d_tpu_torch import problems as TP
from criteria3d_tpu_torch.parallel.sharding import gather_pytree, make_mesh, shard_pytree
from criteria3d_tpu_torch.solver import coupled as TC
from criteria3d_tpu_torch.solver import device_loop
from criteria3d_tpu_torch.solver import heat as TH
from tests.test_torch_core import port_grid, port_state, to_arrays

torch.set_num_threads(1)

N, SEED = 12, 3

FORMS = {
    "f64_vapor": lambda m: m.SolverParameters(heat_vapor=True),
    "fast_exact": lambda m: m.SolverParameters.fast_f32(heat_vapor=True),
    "fast_frozen": lambda m: m.SolverParameters.fast_f32(heat_vapor=True,
                                                         heat_frozen_props=True),
    "advection": lambda m: m.SolverParameters(heat_vapor=True, heat_advection=True),
    "bundle": lambda m: m.SolverParameters.fast_f32(use_pallas=True, heat_vapor=True,
                                                    heat_frozen_props=True),
}

# case: (form, parameter overrides, net irradiance [W/m2], period [s],
# max_substeps)
CASES = {
    **{form: (form, {}, 80.0, 1800.0, 256) for form in FORMS},
    # |heatMBR| > 1 halves sub-steps (9 rejected)
    "halving": ("fast_frozen", {}, 80.0, 1200.0, 256),
    # dtMin 30 s: sub-steps of <= 300 s are accepted whatever their MBR
    "accept_as_is": ("f64_vapor", dict(delta_t_min=30.0), 80.0, 1200.0, 256),
    # 600 W/m2: the first chunk's Courant number cuts it (5 chunks, 1 step)
    "courant_chunk": ("fast_exact", {}, 600.0, 600.0, 256),
    # halvings change the sub-step length: the energy cache is rebuilt
    "cache_rebuild": ("fast_exact", {}, 80.0, 1200.0, 256),
    # 2 chunks where 5 would cover the step
    "max_substeps": ("f64_vapor", {}, 600.0, 600.0, 2),
}

# the counts of commit f376264's host loops on each case's inputs
# (coupled.counts()): steps, attempts, approximations, inner iterations,
# chunks, accepted and rejected sub-steps, heat sweeps
HOST_LOOP_COUNTS = {
    "f64_vapor": (14, 17, 60, 574, 14, 129, 42, 889),
    "fast_exact": (14, 17, 61, 156, 14, 129, 42, 663),
    "fast_frozen": (11, 14, 54, 147, 11, 32, 9, 179),
    "advection": (14, 17, 59, 559, 21, 146, 47, 982),
    "bundle": (11, 14, 53, 464, 11, 32, 9, 179),
    "halving": (7, 10, 42, 123, 7, 28, 9, 157),
    "accept_as_is": (7, 10, 41, 403, 7, 7, 0, 48),
    "courant_chunk": (1, 1, 1, 2, 5, 5, 0, 24),
    "cache_rebuild": (9, 12, 47, 130, 9, 65, 24, 353),
    "max_substeps": (1, 1, 1, 8, 2, 2, 0, 12),
}

_COUNT_KEYS = ("steps", "attempts", "approximations", "inner_iterations", "chunks",
               "substeps_accepted", "substeps_rejected", "heat_sweeps")


def jax_inputs(case: str):
    """The case's parameters of both packages, its JAX inputs and its
    port inputs on the CPU (the JAX objects carried across)."""
    form, kw, irradiance, period, max_substeps = CASES[case]
    jp = dataclasses.replace(FORMS[form](J), **kw)
    tp = dataclasses.replace(FORMS[form](T), **kw)
    dem = TP.synthetic_catchment(SEED, n=N, radius=N * 0.45)
    jg = J.Grid.build(dem, 4.0, J.SoilFields.uniform(dem.shape, **TP.CLAY_LOAM),
                      total_depth=0.8, min_thickness=0.04, max_thickness=0.25,
                      max_thickness_depth=0.6)
    jg = dataclasses.replace(
        jg, btype=jg.btype.at[1].set(jnp.where(jg.mask[1], int(JBT.HEAT_SURFACE),
                                               jg.btype[1])),
        bsize=jg.bsize.at[1].set(jnp.where(jg.mask[1], float(jg.area), jg.bsize[1])))
    jw = j_ib(jg, jp, J.WaterState.initialize(jg, jp, matric_potential=-2.0))
    rain = 0.020 * float(jg.area) / 3600.0
    jw = dataclasses.replace(jw, sink_source=jnp.zeros_like(jw.sink_source).at[0].set(
        jnp.where(jg.mask[0], rain, 0.0)))
    jh = JH.initialize_heat(jg, 288.15)
    storage = JH.heat_storage(jg, jp, jh, jw)
    jh = dataclasses.replace(jh, storage_prev=storage, storage_whole=storage)
    jb = JH.HeatBoundary.uniform(jg.shape[1:], air_temperature=291.15,
                                 rel_humidity=85.0, wind_speed=3.0,
                                 net_irradiance=irradiance, mask=jg.mask[1])
    port = (port_grid(jg), port_state(jw),
            convert.heat_state_from_arrays(to_arrays(jh), device="cpu"),
            convert.heat_boundary_from_arrays(to_arrays(jb), device="cpu"))
    return jp, tp, (jg, jw, jh, jb), port, period, max_substeps


def run_port(tp, port, period, max_substeps):
    """The port's period under the eager driver, with the branches it took
    recorded: Courant cuts of a chunk, sub-steps accepted with |MBR| > 1,
    cache rebuilds. Returns (water, heat, counts, record, drivers' counts)."""
    record = dict(cuts=0, as_is=0, rebuilds=0)
    chunk_dt, balance, rebuild = TH.chunk_dt, TH.substep_balance, TC._CoupledMachine._rebuild

    def cut(params, courant, dt_max):
        dt = chunk_dt(params, courant, dt_max)
        record["cuts"] += int(bool(dt < dt_max))
        return dt

    def substep_balance(*args):
        sink, mbr, ok = balance(*args)
        record["as_is"] += int(bool(ok & (mbr.abs() > 1.0)))
        return sink, mbr, ok

    def counted_rebuild(machine):
        record["rebuilds"] += 1
        rebuild(machine)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TH, "chunk_dt", cut)
        mp.setattr(TH, "substep_balance", substep_balance)
        mp.setattr(TC._CoupledMachine, "_rebuild", counted_rebuild)
        TC.reset_counts()
        device_loop.reset_counts()
        w, h = TC.compute_period_coupled(*port[:1], tp, *port[1:], period,
                                         max_substeps=max_substeps)
    return w, h, TC.counts(), record, device_loop.counts()


def assert_matches_jax(case, jp, tp, jin, w, h, counts, period, max_substeps):
    jg, jw, jh, jb = jin
    jwo, jho = j_period(jg, jp, jw, jh, jb, period, max_substeps=max_substeps)
    mask = np.asarray(jg.mask)
    heat_mask = mask.copy()
    heat_mask[0] = False
    e_h = float(np.abs(w.h.numpy() - np.asarray(jwo.h))[mask].max())
    e_t = float(np.abs(h.t.numpy() - np.asarray(jho.t))[heat_mask].max())
    print(f"{case}: {counts}; max|dh| {e_h} m, max|dT| {e_t} K; water MBR "
          f"{float(w.balance_whole.mbr)} vs {float(jwo.balance_whole.mbr)}; heat sink "
          f"{float(h.sink_whole)} vs {float(jho.sink_whole)}")
    f64 = tp.sweep_dtype in (None, torch.float64)
    dh, dT = (1e-9, 1e-7) if f64 else (1e-4, 1e-3 if tp.heat_frozen_props else 1.5e-2)
    assert e_h <= dh and e_t <= dT
    assert w.h.dtype == h.t.dtype == torch.float64
    assert float(w.balance_whole.mbr) == pytest.approx(
        float(jwo.balance_whole.mbr), rel=1e-9 if f64 else 1e-5, abs=1e-9 if f64 else 1e-6)


def assert_host_loop_counts(case, counts):
    assert tuple(counts[k] for k in _COUNT_KEYS) == HOST_LOOP_COUNTS[case]


@pytest.mark.parametrize("form", list(FORMS))
def test_coupled_machine_matches_jax(form):
    """A 1800 s coupled storm period of each form: the port's machine
    under the eager driver against JAX's ``compute_period_coupled`` (h, T
    and water MBR at the module's tolerances), every count the parent's
    host loops gave, one eager period and no graph."""
    jp, tp, jin, port, period, max_substeps = jax_inputs(form)
    w, h, counts, _, drivers = run_port(tp, port, period, max_substeps)
    assert drivers["eager_periods"] == 1 and drivers["graph_periods"] == 0
    assert_host_loop_counts(form, counts)
    assert counts["substeps_rejected"] > 0 and counts["heat_sweeps"] > 0
    assert_matches_jax(form, jp, tp, jin, w, h, counts, period, max_substeps)


@pytest.mark.parametrize("branch", [c for c in CASES if c not in FORMS])
def test_forced_branches_match_jax(branch):
    """A period forced down each rare branch of the heat sub-stepping
    against JAX: the branch taken (recorded on the port's side), every
    count the parent's host loops gave, h, T and water MBR within the
    module's tolerances."""
    jp, tp, jin, port, period, max_substeps = jax_inputs(branch)
    w, h, counts, record, _ = run_port(tp, port, period, max_substeps)
    print(f"{branch}: recorded {record}")
    assert_host_loop_counts(branch, counts)
    if branch == "halving":
        assert counts["substeps_rejected"] > 0
    elif branch == "accept_as_is":
        assert counts["substeps_rejected"] == 0 and record["as_is"] > 0
    elif branch == "courant_chunk":
        assert record["cuts"] > 0 and counts["chunks"] > counts["steps"]
    elif branch == "cache_rebuild":
        assert record["rebuilds"] == counts["substeps_rejected"] > 0
    else:
        assert counts["chunks"] == max_substeps * counts["steps"] and record["cuts"] > 0
    assert_matches_jax(branch, jp, tp, jin, w, h, counts, period, max_substeps)


def test_driver_off_the_card_and_on_a_mesh():
    """The coupled period takes the eager driver on the CPU, the graph
    driver on a mesh of one card's blocks and the rounds driver on a mesh
    over several cards (``driver_for`` names each), and the machine on a
    (1, 1) CPU mesh (one
    block with its 8-cell ring; tests/test_torch_sharding_heat.py runs four
    meshes of more blocks on a larger box) gives the whole box's counts,
    host reads, h and T to the bit."""
    from criteria3d_tpu_torch.device import host_read
    _, tp, _, port, _, _ = jax_inputs("fast_frozen")
    assert device_loop.driver_for(torch.device("cpu"), None)[0] == "eager"
    mesh = make_mesh(1, devices=[torch.device("cpu")])
    assert device_loop.driver_for(torch.device("cpu"), mesh)[0] == "eager"
    cuda0, cuda1 = torch.device("cuda", 0), torch.device("cuda", 1)
    assert device_loop.driver_for(cuda0, make_mesh(4, devices=[cuda0] * 4)) == ("graph", "")
    assert device_loop.driver_for(cuda0, make_mesh(2, devices=[cuda0, cuda1])) == ("rounds", "")
    runs = []
    for m in (None, mesh):
        inputs = port if m is None else [shard_pytree(x, m) for x in port]
        p = dataclasses.replace(tp, mesh=m)
        TC.reset_counts()
        device_loop.reset_counts()
        host_read.count = 0
        w, h = TC.compute_period_coupled(inputs[0], p, *inputs[1:], 600.0)
        runs.append((gather_pytree(w), gather_pytree(h), TC.counts(), host_read.count,
                     device_loop.counts()))
    (w1, h1, c1, r1, d1), (w2, h2, c2, r2, d2) = runs
    assert d1["eager_periods"] == d2["eager_periods"] == 1
    assert d1["graph_periods"] == d2["graph_periods"] == 0
    assert c1 == c2 and r1 == r2 and c1["heat_sweeps"] > 0
    assert torch.equal(w1.h, w2.h) and torch.equal(h1.t, h2.t)

"""The water period's state machine (solver/step.py's ``_Machine``, run by
solver/device_loop.py's eager driver on the CPU) against the JAX package's
nested ``lax.while_loop``s: storm and drainage hours of the three forms of
the main path, single steps forced down each rare branch (the Courant cut,
a halving on divergence, the restore of the best iterate, the fatal NaN),
and the device form of ``_decimal_floor_dt``. The graph driver runs only on
the card: tests/test_torch_cuda.py holds it to this driver there.

Tolerances: the float64 path to 1e-9 m and MBR 1e-9 (XLA:CPU's FMAs and
log1p, tests/test_torch_f64.py), every count equal; the float32 paths to
heads 1e-4 m and MBR 1e-6 (tests/test_torch_step.py, test_torch_cg.py),
steps, attempts and approximations equal and the inner iterations within
1% (test_torch_step.py's bar: float32 ulps of log1p, powers and sum
orders can move one convergence check across the tolerance; the 32
valley's storm hour takes 2,048 sweeps against JAX's 2,056 and 154 CG
iterations against 155).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import criteria3d_tpu as J
from criteria3d_tpu.solver import step as JSt
from criteria3d_tpu.solver import water as JW
from criteria3d_tpu.solver.step import compute_period_stats as j_period_stats
import criteria3d_tpu_torch as T
from criteria3d_tpu_torch.device import host_read
from criteria3d_tpu_torch.parallel.sharding import make_mesh
from criteria3d_tpu_torch.solver import device_loop
from criteria3d_tpu_torch.solver import step as TSt
from criteria3d_tpu_torch.solver import water as TW
from tests.test_catchment3d import valley_dem
from tests.test_torch_core import build_grids, rain_states

torch.set_num_threads(1)

FORMS = {
    "bundle": lambda m: m.SolverParameters.fast_f32(use_pallas=True),
    "cg_line": lambda m: m.SolverParameters.fast_f32(),
    "f64": lambda m: m.SolverParameters(),
}


def _assert_period(label, form, jout, jstats, tout, tstats):
    jstats = tuple(int(s) for s in jstats)
    dh = float(np.abs(tout.h.numpy() - np.asarray(jout.h)).max())
    mbr_t, mbr_j = float(tout.balance_whole.mbr), float(jout.balance_whole.mbr)
    print(f"{label} {form}: port {tstats} jax {jstats} max|dh| {dh} m MBR port "
          f"{mbr_t} jax {mbr_j}")
    if form == "f64":
        assert tstats == jstats
    else:
        assert tstats[:3] == jstats[:3]
        assert abs(tstats[3] - jstats[3]) <= 0.01 * jstats[3], (tstats, jstats)
    atol, mbr_tol = (1e-9, 1e-9) if form == "f64" else (1e-4, 1e-6)
    np.testing.assert_allclose(tout.h.numpy(), np.asarray(jout.h), rtol=0, atol=atol)
    assert mbr_t == pytest.approx(mbr_j, abs=mbr_tol)
    assert float(tout.dt_curr) == float(jout.dt_curr)


@pytest.mark.parametrize("form", list(FORMS))
def test_storm_and_drainage_hours_match_jax(form):
    """A 20 mm/h storm hour on valley_dem(32) from psi -1.5 m, then a
    drainage hour from each package's end state with the sink at zero, the
    port's machine under the eager driver: the storm hour's stats within
    the form's bars (module docstring), heads and MBR too, dt_curr equal;
    the float64 drainage hour the same, the float32 ones within
    tests/test_fast_f32.py's free-running envelopes (max 0.1 m, median
    1e-2 m, |MBR| < 2e-3); the driver's reads are the hour's only host
    reads, fewer than its units (none after a unit whose next phase is
    ``_Machine.follows``')."""
    jp, tp = FORMS[form](J), FORMS[form](T)
    jg, tg = build_grids(valley_dem(32))
    js, ts = rain_states(jg, jp, tg, tp, psi0=-1.5, rain_mm_h=20.0)
    device_loop.reset_counts()
    host_read.count = 0
    jout, jstats = j_period_stats(jg, jp, js, 3600.0)
    tout, tstats = T.compute_period_stats(tg, tp, ts, 3600.0)
    counts = device_loop.counts()
    assert counts["eager_periods"] == 1 and counts["graph_periods"] == 0
    assert host_read.count == counts["eager_reads"] < counts["eager_units"]
    _assert_period("storm hour", form, jout, jstats, tout, tstats)
    jd = dataclasses.replace(jout, sink_source=jnp.zeros_like(jout.sink_source))
    td = dataclasses.replace(tout, sink_source=torch.zeros_like(tout.sink_source))
    jout2, jstats2 = j_period_stats(jg, jp, jd, 3600.0)
    tout2, tstats2 = T.compute_period_stats(tg, tp, td, 3600.0)
    if form == "f64":
        _assert_period("drainage hour", form, jout2, jstats2, tout2, tstats2)
        return
    # float32 drainage compounds the storm hour's one check apart (steps
    # 23 / 27 bundle, 22 / 26 CG line here): the free-running float32
    # envelopes of tests/test_fast_f32.py
    err = np.abs(tout2.h.numpy() - np.asarray(jout2.h))[np.asarray(jg.mask)]
    mbr_t, mbr_j = float(tout2.balance_whole.mbr), float(jout2.balance_whole.mbr)
    print(f"drainage hour {form}: port {tstats2} jax {tuple(int(v) for v in jstats2)} "
          f"max|dh| {err.max()} m median {np.median(err)} m MBR port {mbr_t} jax {mbr_j}")
    assert err.max() < 0.1 and np.median(err) < 1e-2
    assert abs(mbr_t) < 2e-3 and abs(mbr_j) < 2e-3


def _ponded(jg, jp, tg, tp):
    """0.3 m of water on every surface cell over soil at psi -0.5 m: a
    surface Courant number far past 1 at dt = delta_t_max."""
    js = JSt.initialize_balance(jg, jp, J.WaterState.initialize(
        jg, jp, matric_potential=-0.5, surface_water=0.3))
    ts = T.initialize_balance(tg, tp, T.WaterState.initialize(
        tg, tp, matric_potential=-0.5, surface_water=0.3, device="cpu"))
    return js, ts


def _nan_rain(jg, jp, tg, tp):
    """20 mm/h of rain with a NaN on one surface cell."""
    js, ts = rain_states(jg, jp, tg, tp, psi0=-1.0, rain_mm_h=20.0)
    r, c = (int(v) for v in np.argwhere(np.asarray(jg.mask[0]))[0])
    js = dataclasses.replace(js, sink_source=js.sink_source.at[0, r, c].set(jnp.nan))
    sink = ts.sink_source.clone()
    sink[0, r, c] = float("nan")
    return js, dataclasses.replace(ts, sink_source=sink)


def _rain(jg, jp, tg, tp):
    return rain_states(jg, jp, tg, tp, psi0=-1.0, rain_mm_h=20.0)


# branch: (parameters, initial states, the port function counted, whether
# the step's heads are finite)
BRANCHES = {
    "courant_cut": (dict(), _ponded, "_decimal_floor_dt"),
    # every sweep's norm scaled by 1e12 in both packages: the first sweep of
    # every solve diverges, halving dt down to delta_t_min
    "diverged": (dict(delta_t_min=60.0), _rain, None),
    # tests/test_torch_f64.py's restore run: the balance never closes, so
    # the step restores its best iterate
    "restore": (dict(delta_t_min=60.0, delta_t_max=60.0, mbr_threshold=1e-8,
                     max_approximations=3), _rain, "restore_best_step"),
    # dt locked at delta_t_min: a NaN balance at approx 0 cannot halve
    "fatal_nan": (dict(delta_t_min=60.0, delta_t_max=60.0), _nan_rain, None),
}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_forced_branches_match_jax_compute_step(branch, monkeypatch):
    """One float64 step (per-sweep Jacobi) on valley_dem(12) forced down a
    rare branch of the step, the port's machine against JAX's jitted
    ``_compute_step``: the same dt, (attempts, approximations, sweeps) and
    dt_curr, heads within 1e-9 m (the fatal NaN: the input heads, and the
    result code's NaN balance in both), and the branch taken."""
    kw, make_states, counted = BRANCHES[branch]
    jp, tp = J.SolverParameters(**kw), T.SolverParameters(**kw)
    jg, tg = build_grids(valley_dem(12))
    js, ts = make_states(jg, jp, tg, tp)
    if branch == "diverged":
        j_sweep, t_sweep = JW.jacobi_sweep, TW.jacobi_sweep_sum
        monkeypatch.setattr(JW, "jacobi_sweep",
                            lambda *a: (lambda x, n: (x, n * 1e12))(*j_sweep(*a)))
        monkeypatch.setattr(TW, "jacobi_sweep_sum",
                            lambda *a: (lambda x, n: (x, n * 1e12))(*t_sweep(*a)))
    calls = []
    if counted == "_decimal_floor_dt":
        floor = TSt._decimal_floor_dt
        monkeypatch.setattr(TSt, "_decimal_floor_dt",
                            lambda dt: calls.append(1) or floor(dt))
    TSt.restore_best_step.count = 0
    jstate, jdt, jstats, _ = jax.jit(lambda st: JSt._compute_step(
        jg, jp, st, jnp.asarray(600.0)))(js)
    tstate, tdt, tstats, _, dt_curr = TSt._compute_step(tg, tp, ts, 600.0)
    jstats = tuple(int(s) for s in jstats)
    print(f"{branch}: port dt {tdt} stats {tstats} dt_curr {dt_curr}; jax dt "
          f"{float(jdt)} stats {jstats} dt_curr {float(jstate.dt_curr)}")
    assert tdt == float(jdt) and tstats == jstats
    assert dt_curr == float(jstate.dt_curr) == float(tstate.dt_curr)
    np.testing.assert_allclose(tstate.h.numpy(), np.asarray(jstate.h), rtol=0, atol=1e-9)
    if branch == "courant_cut":
        assert calls and dt_curr < 600.0
    elif branch == "diverged":
        assert tstats[0] > 1 and tdt == 60.0
    elif branch == "restore":
        assert TSt.restore_best_step.count > 0
    else:
        assert tstats == (1, 1, tp.max_iterations_for(0))
        assert torch.equal(tstate.h, ts.h)
        assert np.isnan(float(tstate.balance_current.mbr))
        assert np.isnan(float(jstate.balance_current.mbr))


def test_decimal_floor_dt_matches_jax():
    """The device form (a bounded loop, the scale multiplied by 10 with v)
    against JAX's ``_decimal_floor_dt`` over 2,000 seeded values spread over
    1e-20 .. 1e4 s and a few decimal edges: bit-equal."""
    rng = np.random.default_rng(0)
    v = np.concatenate([10.0 ** rng.uniform(-20.0, 4.0, 2000),
                        [1.0, 0.1, 0.3, 0.7, 1e-5, 2.5e-7, 9.999999, 599.99, 600.0]])
    j = np.asarray(jax.jit(jax.vmap(JSt._decimal_floor_dt))(jnp.asarray(v)))
    t = TSt._decimal_floor_dt(torch.from_numpy(v)).numpy()
    assert t.dtype == j.dtype == np.float64
    np.testing.assert_array_equal(t, j)


def test_drivers_and_no_graph_off_the_card():
    """Which driver runs where: the graph on a CUDA device, whole or on a
    mesh whose blocks all lie on its card (the water and the coupled period
    alike: the heat hooks no longer decide it); a water or coupled period on
    a mesh over two distinct cards the rounds driver (one machine a card);
    the CPU and forced_eager (on the card too) take the eager one, the CPU
    with its reason."""
    cuda, cuda0, cuda1 = torch.device("cuda"), torch.device("cuda", 0), torch.device("cuda", 1)
    one_card = make_mesh(4, devices=[cuda0] * 4)
    two_cards = make_mesh(2, devices=[cuda0, cuda1])
    assert device_loop.driver_for(cuda0, None) == ("graph", "")
    assert device_loop.driver_for(cuda0, one_card) == ("graph", "")
    assert device_loop.driver_for(cuda0, make_mesh(1, devices=[cuda0])) == ("graph", "")
    assert device_loop.driver_for(cuda0, two_cards) == ("rounds", "")
    for dev, mesh in ((torch.device("cpu"), None),
                      (torch.device("cpu"), make_mesh(2, devices=["cpu"] * 2))):
        driver, why = device_loop.driver_for(dev, mesh)
        assert driver == "eager" and "cpu" in why
    with device_loop.forced_eager():
        assert device_loop.driver_for(cuda, None)[0] == "eager"
        assert device_loop.driver_for(cuda0, one_card)[0] == "eager"
    assert device_loop.driver_for(cuda, None)[0] == "graph"

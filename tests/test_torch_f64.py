"""The port's float64 parity path against the JAX package: the soil
capacity, the f64 assembly (boundary flows, capacity, conductances,
``assemble_system``), the sweep and the balance on seeded inputs, then
whole simulated hours of ``SolverParameters()`` (per-sweep f64 Jacobi),
the restore branch of the Picard loop and the solver selection.

Both implementations get the same numpy inputs; the port runs on the CPU.
Function-level tolerances are rel 1e-12 with an absolute floor of 1e-12 of
the field's max |value| where a field is 0 or cancels: the two differ by
float64 ulps (XLA:CPU's log1p and its fused multiply-adds under jit).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import criteria3d_tpu as J
from criteria3d_tpu.core import soil as JS
from criteria3d_tpu.solver import water as JW
from criteria3d_tpu.solver.step import compute_period_stats as j_period_stats
import criteria3d_tpu_torch as T
from criteria3d_tpu_torch.core import soil as TS
from criteria3d_tpu_torch.solver import step as TSt
from criteria3d_tpu_torch.solver import water as TW
from tests.test_catchment3d import valley_dem
from tests.test_torch_core import (build_grids, dtype_name, land_use_map,
                                   port_grid, rain_states)

torch.set_num_threads(1)

RTOL = 1e-12


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a))


def assert_close(t, j, rtol=RTOL, name=""):
    """dtype equal; values within rtol, with an absolute floor of rtol of
    the field's max |value| (fields that are 0 or cancel)."""
    assert dtype_name(t) == dtype_name(j), name
    a = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), a, rtol=rtol,
                               atol=rtol * float(np.abs(a).max()), err_msg=name)


def seeded_heads(seed=0, n=10, **pkw):
    """valley_dem(n) with ROAD/URBAN land use, a culvert outlet and a
    prescribed node; seeded float64 heads h, h_old: unsaturated and ponded
    nodes, a tenth with an unchanged potential (the analytic capacity) and
    a twentieth changed by ~3e-12 m (the secant just past its 1e-12 m
    threshold)."""
    jp, tp = J.SolverParameters(**pkw), T.SolverParameters(**pkw)
    jg, _ = build_grids(valley_dem(n), land_use=land_use_map((n, n)))
    jg = jg.set_culvert(n - 1, n // 2, roughness=0.02, slope=0.05,
                        width=1.0, height=0.5)
    jg = jg.set_prescribed(4, 5, 5, float(jg.z[4, 5, 5]) - 0.3)
    tg = port_grid(jg)
    rng = np.random.default_rng(seed)
    shape = jg.shape
    mask, z = np.asarray(jg.mask), np.asarray(jg.z)
    psi = rng.uniform(-2.5, 0.2, shape)
    psi[0] = rng.uniform(0.0, 0.6, shape[1:])
    psi[0, n - 1, n // 2] = 0.9                      # culvert: pressure flow
    step = rng.uniform(0.02, 0.15, shape) * rng.choice([-1, 1], shape)
    u = rng.random(shape)
    step = np.where(u < 0.1, 0.0, np.where(u < 0.15, 3e-12, step))
    psi_old = psi + step
    psi_old[0] = np.maximum(psi_old[0], 0.0)
    h = np.where(mask, z + psi, 0.0)
    h_old = np.where(mask, z + psi_old, 0.0)
    return jp, tp, jg, tg, h, h_old


def test_power_f64_matches_xla():
    """``core.soil.power`` in float64 on the CPU (torch's element-by-element
    loop, the C library's pow) against XLA:CPU's pow: bit-equal in at
    least 99.99% of seeded samples and within one ulp, for a tensor
    exponent and for number exponents (-0.5 included, which torch.pow
    turns into rsqrt); torch.pow's own rates are printed beside it (run
    with -s)."""
    rng = np.random.default_rng(7)
    x = rng.uniform(1e-6, 50.0, 100_000)
    y = rng.uniform(-3.0, 3.0, 100_000)
    for exp_j, exp_t in [(_j(y), _t(y))] + [(e, e) for e in (2.0 / 3.0, 0.54, -0.5)]:
        ref = np.asarray(jnp.power(_j(x), exp_j))
        ours = TS.power(_t(x), exp_t).numpy()
        plain = torch.pow(_t(x), exp_t).numpy()
        same = float(np.mean(ours == ref))
        print(f"float64 pow bit-equal to XLA:CPU, exponent "
              f"{'tensor' if isinstance(exp_t, torch.Tensor) else exp_t}: "
              f"power() {same}, torch.pow {float(np.mean(plain == ref))}")
        assert same >= 0.9999
        np.testing.assert_allclose(ours, ref, rtol=2.0 ** -52, atol=0)


@pytest.mark.parametrize("model", ["MODIFIED_VAN_GENUCHTEN", "VAN_GENUCHTEN"])
def test_dtheta_dh_matches_jax(model):
    """Both retention models; the analytic branch, the secant branch and
    the secant 3e-12 m past its threshold, where one ulp of se would be a
    relative error of ~1e-5: rel 1e-12."""
    jp, tp, jg, tg, h, h_old = seeded_heads(seed=1)
    j = JS.dtheta_dh(jg.soil, _j(h), _j(h_old), jg.z, JS.WRCModel[model])
    t = TS.dtheta_dh(tg.soil, _t(h), _t(h_old), tg.z, TS.WRCModel[model])
    assert_close(t, j, name="dtheta_dh")
    # every branch ran
    same = np.abs(np.minimum(h - np.asarray(jg.z), 0)
                  - np.minimum(h_old - np.asarray(jg.z), 0)) < 1e-12
    assert same[np.asarray(jg.mask)].mean() > 0.05
    assert (np.asarray(j) > 0).mean() > 0.3


def test_se_from_theta_matches_jax():
    """Clipped to [0, 1]: bit-equal (one subtraction and one division)."""
    _, _, jg, tg, _, _ = seeded_heads()
    theta = np.random.default_rng(2).uniform(0.0, 0.5, jg.shape)
    j = JS.se_from_theta(jg.soil, _j(theta))
    t = TS.se_from_theta(tg.soil, _t(theta))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("fast", [False, True], ids=["f64", "fast_f32"])
def test_compute_capacity_matches_jax(fast):
    """Both branches: pure float64 (rel 1e-12), and the float32 working
    dtype one that fast parameters reach through io/state_io.py,
    solver/heat.py and utils/debug_dump.py (rel 1e-5: float32 VG powers
    and a float32 secant)."""
    jp, tp, jg, tg, h, h_old = seeded_heads(seed=3)
    if fast:
        jp = J.SolverParameters.fast_f32()
        tp = T.SolverParameters.fast_f32()
    se = JW.compute_se(jg, jp, _j(h))
    cap_j, k_j = JW.compute_capacity(jg, jp, _j(h), _j(h_old), se)
    cap_t, k_t = TW.compute_capacity(tg, tp, _t(h), _t(h_old), _t(se))
    rtol = 1e-5 if fast else RTOL
    assert_close(cap_t, cap_j, rtol, "capacity")
    assert_close(k_t, k_j, rtol, "k")


@pytest.mark.parametrize("culvert_compat", [True, False])
def test_update_boundary_water_matches_jax(culvert_compat):
    """Every boundary type a grid can hold (runoff rim, free drainage, free
    lateral drainage, prescribed, culvert, urban; a ROAD cell has no soil
    node) and both culvert water levels: rel 1e-12."""
    jp, tp, jg, tg, h, h_old = seeded_heads(
        seed=4, culvert_reference_compat=culvert_compat)
    se = JW.compute_se(jg, jp, _j(h))
    _, k = JW.compute_capacity(jg, jp, _j(h), _j(h_old), se)
    shape = jg.shape
    sink = np.zeros(shape)
    sink[0] = np.where(np.asarray(jg.mask[0]), 0.02 * 100.0 / 3600.0, 0.0)
    sink[0, 3, 3] = -0.05                           # evaporation-limited
    pond = np.full(shape[1:], 0.002)
    fj, rj = JW.update_boundary_water(jg, jp, _j(h), _j(h_old), k, _j(sink),
                                      _j(pond), jnp.asarray(300.0))
    ft, rt = TW.update_boundary_water(tg, tp, _t(h), _t(h_old), _t(k),
                                      _t(sink), _t(pond), 300.0)
    assert_close(ft, fj, name="water_flow")
    assert_close(rt, rj, name="boundary_rate")
    rate, bt = np.asarray(rj), np.asarray(jg.btype)
    for b in (J.BoundaryType.RUNOFF, J.BoundaryType.FREE_DRAINAGE,
              J.BoundaryType.FREE_LATERAL_DRAINAGE,
              J.BoundaryType.PRESCRIBED_TOTAL_POTENTIAL):
        assert np.abs(rate[bt == int(b)]).max() > 0, b.name
    culvert = rate[bt == int(J.BoundaryType.CULVERT)].min()
    assert (culvert == 0) if culvert_compat else (culvert < 0)
    # URBAN soil nodes carry no boundary flow (ROAD cells have no soil
    # nodes at all, project3D.cpp:795)
    assert (bt == int(J.BoundaryType.URBAN)).any()
    assert (rate[bt == int(J.BoundaryType.URBAN)] == 0).all()


@pytest.mark.parametrize("courant_compat,first", [(True, True), (False, False)])
def test_conductances_match_jax(courant_compat, first):
    """``_vertical_conductance`` (infiltration with ROAD/URBAN factors,
    redistribution) and ``_lateral_conductances`` (runoff with the approx-0
    rainfall predictor or without, soil lateral links, the Courant number
    with and without the reference's integer-abs truncation): rel 1e-12."""
    jp, tp, jg, tg, h, h_old = seeded_heads(
        seed=5, courant_reference_compat=courant_compat)
    se = JW.compute_se(jg, jp, _j(h))
    _, k = JW.compute_capacity(jg, jp, _j(h), _j(h_old), se)
    shape = jg.shape
    flow = np.zeros(shape)
    flow[0] = np.where(np.asarray(jg.mask[0]), 3e-3, 0.0)
    flow[0, 2, 2] = -1e-3
    pond = np.full(shape[1:], 0.002)
    dt = 120.0
    aj = JW._vertical_conductance(jg, jp, _j(h), _j(h_old), k, _j(flow),
                                  jnp.asarray(dt))
    at = TW._vertical_conductance(tg, tp, _t(h), _t(h_old), _t(k), _t(flow), dt)
    assert_close(at, aj, name="a_up")
    lj, cj = JW._lateral_conductances(jg, jp, _j(h), _j(h_old), k, _j(flow),
                                      _j(pond), jnp.asarray(first),
                                      jnp.asarray(dt))
    lt, ct = TW._lateral_conductances(tg, tp, _t(h), _t(h_old), _t(k),
                                      _t(flow), _t(pond), first, dt)
    assert_close(lt, lj, name="a_lat")
    assert_close(ct, cj, name="courant")
    assert float(cj) > 0 and np.asarray(aj)[1].max() > 0


@pytest.mark.parametrize("approx", [0, 1])
def test_assemble_system_matches_jax(approx):
    jp, tp, jg, tg, h, h_old = seeded_heads(seed=6)
    se = JW.compute_se(jg, jp, _j(h))
    cap, k = JW.compute_capacity(jg, jp, _j(h), _j(h_old), se)
    shape = jg.shape
    sink = np.zeros(shape)
    sink[0] = np.where(np.asarray(jg.mask[0]), 0.02 * 100.0 / 3600.0, 0.0)
    pond = np.full(shape[1:], 0.002)
    flow, _ = JW.update_boundary_water(jg, jp, _j(h), _j(h_old), k, _j(sink),
                                       _j(pond), jnp.asarray(60.0))
    sj = JW.assemble_system(jg, jp, _j(h), _j(h_old), k, flow, cap, _j(pond),
                            jnp.asarray(approx), jnp.asarray(60.0))
    st = TW.assemble_system(tg, tp, _t(h), _t(h_old), _t(k), _t(flow),
                            _t(cap), _t(pond), approx, 60.0)
    for name in TW.LinearSystem._fields:
        assert_close(getattr(st, name), getattr(sj, name), name=name)


def _system(seed):
    jp, tp, jg, tg, h, h_old = seeded_heads(seed=seed)
    se = JW.compute_se(jg, jp, _j(h))
    cap, k = JW.compute_capacity(jg, jp, _j(h), _j(h_old), se)
    sj = JW.assemble_system(jg, jp, _j(h), _j(h_old), k, jnp.zeros_like(k),
                            cap, jnp.full(jg.shape[1:], 0.002),
                            jnp.asarray(0), jnp.asarray(60.0))
    return jp, tp, jg, tg, h, sj, TW.LinearSystem(*(_t(a) for a in sj))


def test_jacobi_sweep_matches_jax():
    """One f64 sweep with the surface clamp x >= z: x and the norm to
    rel 1e-12."""
    jp, tp, jg, tg, h, sj, st = _system(7)
    xj, nj = JW.jacobi_sweep(sj, _j(h), jg, jg.n_nodes)
    xt, nt = TW.jacobi_sweep(st, _t(h), tg, tg.n_nodes)
    assert_close(xt, xj, name="x")
    assert float(nt) == pytest.approx(float(nj), rel=RTOL)


def test_current_mass_balance_matches_jax():
    """storage, sink, MBE and MBR (float64 sums in another order): rel
    1e-12; the MBE is a small difference of two sums, so it is held to
    rel 1e-12 of the storage."""
    jp, tp, jg, tg, h, _ = seeded_heads(seed=8)
    se = JW.compute_se(jg, jp, _j(h))
    flow = np.random.default_rng(8).uniform(-1e-4, 3e-4, jg.shape)
    bj = JW.current_mass_balance(jg, jp, _j(h), se, _j(flow),
                                 jnp.asarray(900.0), jnp.asarray(120.0))
    bt = TW.current_mass_balance(tg, tp, _t(h), _t(se), _t(flow),
                                 torch.tensor(900.0, dtype=torch.float64), 120.0)
    storage = float(bj[0])
    for name, j, t in zip(("storage", "sink", "mbe", "mbr"), bj, bt):
        assert dtype_name(t) == dtype_name(j) == "float64", name
        atol = RTOL * storage if name == "mbe" else 0.0
        np.testing.assert_allclose(float(t), float(j), rtol=RTOL, atol=atol,
                                   err_msg=name)


# ----------------------------------------------------------------------
# whole hours
# ----------------------------------------------------------------------

def _assert_hour(jout, jstats, tout, tstats, label):
    jstats = tuple(int(s) for s in jstats)
    dh = float(np.abs(tout.h.numpy() - np.asarray(jout.h)).max())
    mbr_t, mbr_j = float(tout.balance_whole.mbr), float(jout.balance_whole.mbr)
    print(f"{label}: port {tstats} jax {jstats} max|dh| {dh} m "
          f"MBR port {mbr_t} jax {mbr_j}")
    assert tstats == jstats
    np.testing.assert_allclose(tout.h.numpy(), np.asarray(jout.h), rtol=0,
                               atol=1e-9)
    assert mbr_t == pytest.approx(mbr_j, abs=1e-9)
    assert tout.h.dtype == torch.float64


def test_f64_storm_then_drainage_matches_jax():
    """SolverParameters() on valley_dem(10), psi0 = -1.5 m, a 15 mm/h storm
    hour, then a drainage hour from each package's end state with the sink
    at zero: identical stats tuples, heads within 1e-9 m, whole-period MBR
    within 1e-9."""
    jp, tp = J.SolverParameters(), T.SolverParameters()
    jg, tg = build_grids(valley_dem(10))
    js, ts = rain_states(jg, jp, tg, tp, psi0=-1.5, rain_mm_h=15.0)
    jout, jstats = j_period_stats(jg, jp, js, 3600.0)
    tout, tstats = T.compute_period_stats(tg, tp, ts, 3600.0)
    _assert_hour(jout, jstats, tout, tstats, "f64 storm hour")
    jd = dataclasses.replace(jout, sink_source=jnp.zeros_like(jout.sink_source))
    td = dataclasses.replace(tout, sink_source=torch.zeros_like(tout.sink_source))
    jout2, jstats2 = j_period_stats(jg, jp, jd, 3600.0)
    tout2, tstats2 = T.compute_period_stats(tg, tp, td, 3600.0)
    _assert_hour(jout2, jstats2, tout2, tstats2, "f64 drainage hour")


def test_f64_restore_branch_matches_jax():
    """dt locked at 60 s (no halving) with a 1e-8 MBR gate and three Picard
    iterations: the balance never closes, so every step restores its best
    iterate (restoreBestStep, the float64 recompute of capacity, flows and
    balance). The port's restore counter is > 0; stats identical and heads
    within 1e-9 m over 600 s."""
    kw = dict(delta_t_min=60.0, delta_t_max=60.0, mbr_threshold=1e-8,
              max_approximations=3)
    jp, tp = J.SolverParameters(**kw), T.SolverParameters(**kw)
    jg, tg = build_grids(valley_dem(8))
    js, ts = rain_states(jg, jp, tg, tp, psi0=-1.0, rain_mm_h=20.0)
    jout, jstats = j_period_stats(jg, jp, js, 600.0)
    TSt.restore_best_step.count = 0
    tout, tstats = T.compute_period_stats(tg, tp, ts, 600.0)
    print(f"restores {TSt.restore_best_step.count}")
    assert TSt.restore_best_step.count > 0
    _assert_hour(jout, jstats, tout, tstats, "f64 restore run")


def test_use_pallas_runs_f64_per_sweep(monkeypatch):
    """SolverParameters(use_pallas=True) runs per-sweep float64 Jacobi, as
    in the JAX package (the bundle only on the fast path): the bundle loop
    is never entered, and the stats equal JAX's for the same parameters."""
    def no_bundle(*args, **kw):
        raise AssertionError("the float64 path entered the bundled kernel loop")
    monkeypatch.setattr(TSt, "jacobi_bundle", no_bundle)
    jp, tp = J.SolverParameters(use_pallas=True), T.SolverParameters(use_pallas=True)
    jg, tg = build_grids(valley_dem(8))
    js, ts = rain_states(jg, jp, tg, tp, psi0=-1.0, rain_mm_h=20.0)
    jout, jstats = j_period_stats(jg, jp, js, 1800.0)
    tout, tstats = T.compute_period_stats(tg, tp, ts, 1800.0)
    _assert_hour(jout, jstats, tout, tstats, "f64 use_pallas=True")

"""The port's first slice as a whole against the JAX package: one adaptive
step and whole simulated hours of the float32 psi-carry path, with the
bundled Jacobi solver (``use_pallas=True``; the plain twin on the CPU, the
Pallas kernel in interpret mode on the JAX side) and with per-sweep Jacobi;
and what the port still refuses. The float64 path, CG and link flows are in
tests/test_torch_f64.py, test_torch_cg.py and test_torch_link_flows.py."""

import dataclasses

import numpy as np
import pytest
import torch

import criteria3d_tpu as J
from criteria3d_tpu.solver.step import compute_period_stats as j_period_stats
import criteria3d_tpu_torch as T
from criteria3d_tpu_torch.device import host_read
from criteria3d_tpu_torch.solver import jacobi_bundle as TB
from criteria3d_tpu_torch.solver import step as TSt
from criteria3d_tpu_torch.solver import water as TW
from tests.test_catchment3d import valley_dem
from tests.test_torch_core import build_grids, rain_states

torch.set_num_threads(1)


def test_one_step_matches_jax():
    """compute_step, fast_f32(use_pallas=True), valley_dem(16), 20 mm/h
    (tests/test_sharding.py's configuration): the same dt, heads within
    1e-5 m."""
    jp = J.SolverParameters.fast_f32(use_pallas=True)
    tp = T.SolverParameters.fast_f32(use_pallas=True)
    jg, tg = build_grids(valley_dem(16))
    js, ts = rain_states(jg, jp, tg, tp, psi0=-1.0, rain_mm_h=20.0)
    jout, jdt = J.compute_step(jg, jp, js, 3600.0)
    tout, tdt = T.compute_step(tg, tp, ts, 3600.0)
    assert tdt == float(jdt)
    np.testing.assert_allclose(tout.h.numpy(), np.asarray(jout.h), rtol=0,
                               atol=1e-5)
    assert float(tout.balance_current.mbr) == pytest.approx(
        float(jout.balance_current.mbr), abs=1e-6)
    assert float(tout.dt_curr) == float(jout.dt_curr)


def _hour(use_pallas, locked, start_seconds=0.0):
    kw = dict(use_pallas=use_pallas, inner_solver="jacobi")
    if locked:
        kw.update(delta_t_min=60.0, delta_t_max=60.0)
    jp = J.SolverParameters.fast_f32(**kw)
    tp = T.SolverParameters.fast_f32(**kw)
    jg, tg = build_grids(valley_dem(10))
    js, ts = rain_states(jg, jp, tg, tp, psi0=-1.5, rain_mm_h=15.0)
    jout, jstats = j_period_stats(jg, jp, js, 3600.0, start_seconds)
    TB.jacobi_bundle.launches = 0
    tout, tstats = T.compute_period_stats(tg, tp, ts, 3600.0, start_seconds)
    return jg, jout, tuple(int(s) for s in jstats), tout, tstats


@pytest.mark.parametrize("locked", [False, True], ids=["free", "dt60"])
@pytest.mark.parametrize("use_pallas", [True, False], ids=["bundle", "sweep"])
def test_hour_matches_jax(use_pallas, locked):
    """compute_period_stats over 3600 s on valley_dem(10), psi0 = -1.5 m,
    15 mm/h (tests/test_fast_f32.py's problem): heads within 1e-4 m,
    whole-period MBR within 1e-6 and |MBR| < 2e-3.

    Free-running, the solver-effort counts are identical. With dt locked
    at 60 s the step, attempt and approximation counts are identical and
    the sweep count is held to 1%: the two implementations differ by f32
    ulps (log1p, some powers, sum orders), and over 121 solves such an ulp
    can move one convergence check across the tolerance, by one bundle
    or one sweep (PERF.md, tolerances)."""
    jg, jout, jstats, tout, tstats = _hour(use_pallas, locked)
    dh = float(np.abs(tout.h.numpy() - np.asarray(jout.h)).max())
    print(f"hour use_pallas={use_pallas} locked={locked}: port {tstats} "
          f"jax {jstats} max|dh| {dh} m")
    if locked:
        assert tstats[:3] == jstats[:3] == (60, 60, tstats[2])
        assert abs(tstats[3] - jstats[3]) <= 0.01 * jstats[3], (tstats, jstats)
    else:
        assert tstats == jstats
    np.testing.assert_allclose(tout.h.numpy(), np.asarray(jout.h), rtol=0,
                               atol=1e-4)
    mbr_t, mbr_j = float(tout.balance_whole.mbr), float(jout.balance_whole.mbr)
    assert mbr_t == pytest.approx(mbr_j, abs=1e-6)
    assert abs(mbr_t) < 2e-3
    # on the CPU the bundle wrapper runs the plain twin: no kernel launch
    assert TB.jacobi_bundle.launches == 0


def test_resumed_period_matches_jax():
    """start_seconds > 0 keeps the period sink counter and covers only the
    rest of the period, as in the JAX package."""
    jg, jout, jstats, tout, tstats = _hour(True, False, start_seconds=2400.0)
    assert tstats == jstats
    np.testing.assert_allclose(tout.h.numpy(), np.asarray(jout.h), rtol=0,
                               atol=1e-4)
    for name in ("balance_period", "balance_whole"):
        jb, tb = getattr(jout, name), getattr(tout, name)
        storage = float(jb.storage)
        # storage and sink to f32 rounding of the summed node values; the
        # MBE is their small difference, so its tolerance is one of storage
        for field, tol in (("storage", 1e-7 * storage),
                           ("sink_source", 1e-7 * storage),
                           ("mbe", 1e-7 * storage), ("mbr", 1e-6)):
            a, b = float(getattr(jb, field)), float(getattr(tb, field))
            assert b == pytest.approx(a, rel=0, abs=tol), (name, field)


def test_host_syncs_are_counted():
    """Every scalar decision goes through host_read: an hour's count is
    at least one per bundle and one per balance evaluation."""
    tp = T.SolverParameters.fast_f32(use_pallas=True)
    jp = J.SolverParameters.fast_f32(use_pallas=True)
    jg, tg = build_grids(valley_dem(8))
    _, ts = rain_states(jg, jp, tg, tp, psi0=-1.0, rain_mm_h=20.0)
    host_read.count = 0
    _, stats = T.compute_period_stats(tg, tp, ts, 3600.0)
    bundles = stats[3] // TB.SWEEPS_PER_BUNDLE
    assert host_read.count >= bundles + stats[2]


@pytest.mark.parametrize("config", ["extra_flux", "f64_hooks"])
def test_unported_configurations_raise(config):
    """What no solver runs fails loudly; nothing falls back. The
    heat-coupling hooks, refused before the heat slice, now run:
    ``assemble_fast`` takes them on the fast path and the step (the entry
    solver/coupled.py calls with them) on the float64 path, and hooks that
    add nothing give the hook-free result bit for bit. An unknown sweep
    dtype, inner solver or CG preconditioner still raises ``ValueError``."""
    _, tg = build_grids(valley_dem(6), total_depth=0.4)
    p = (T.SolverParameters.fast_f32(use_pallas=True) if config == "extra_flux"
         else T.SolverParameters())
    state = T.initialize_balance(tg, p, T.WaterState.initialize(
        tg, p, matric_potential=-1.0, device="cpu"))
    hooks = dict(extra_flux_fn=lambda psi, k: torch.zeros_like(psi),
                 boundary_flux_fn=lambda psi, dt: torch.zeros_like(psi))
    if config == "extra_flux":
        psi = torch.where(tg.mask, -1.0, 0.0).to(torch.float32)
        se = TW.compute_se_psi(tg, p, psi)
        args = (tg, p, psi, psi, se, state.sink_source, state.pond, 0, 60.0)
        with_hooks, plain = TW.assemble_fast(*args, **hooks), TW.assemble_fast(*args)
        assert all(torch.equal(a, b) for a, b in zip(with_hooks[0], plain[0]))
    else:
        with_hooks = TSt._compute_step(tg, p, state, 600.0, **hooks)
        plain = TSt._compute_step(tg, p, state, 600.0)
        assert with_hooks[1:3] == plain[1:3]
        assert torch.equal(with_hooks[0].h, plain[0].h)
    for bad in (dict(inner_solver="gmres"), dict(sweep_dtype=torch.float16),
                dict(inner_solver="cg", cg_precond="ilu")):
        with pytest.raises(ValueError):
            TSt._compute_step(tg, dataclasses.replace(p, **bad), state, 600.0)

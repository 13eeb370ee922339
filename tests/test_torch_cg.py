"""The port's conjugate-gradient inner solver against the JAX package: the
stencil matvec, the vertical line preconditioner (batched Thomas), one CG
solve of an assembled system for each preconditioner and form, and whole
simulated hours of CG on the float64 path and under ``fast_f32()`` (CG with
the line preconditioner, the production preset).

Both implementations get the same numpy inputs; the port runs on the CPU.
"""

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
from criteria3d_tpu_torch.solver import step as TSt
from criteria3d_tpu_torch.solver import water as TW
from tests.test_catchment3d import valley_dem
from tests.test_torch_core import build_grids, dtype_name, rain_states
from tests.test_torch_f64 import seeded_heads
from tests.test_torch_water import seeded_case

torch.set_num_threads(1)


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def no_jacobi(monkeypatch):
    """CG must not run Jacobi: every Jacobi entry of the step raises."""
    def refuse(*args, **kw):
        raise AssertionError("a CG configuration ran a Jacobi solve")
    monkeypatch.setattr(TSt, "jacobi_bundle", refuse)
    monkeypatch.setattr(TW, "jacobi_sweep", refuse)
    monkeypatch.setattr(TW, "jacobi_sweep_psi", refuse)


def seeded_system(shape, dtype, seed):
    """A seeded stencil system (numpy), couplings zero across the box edge
    and at masked nodes, as the assembly leaves them."""
    rng = np.random.default_rng(seed)
    L, R, C = shape
    mask = rng.random(shape) < 0.9
    c_up = rng.uniform(0, 0.2, shape) * mask
    c_up[0] = 0.0
    c_down = rng.uniform(0, 0.2, shape) * mask
    c_down[-1] = 0.0
    c_lat = rng.uniform(0, 0.07, (8,) + shape) * mask
    b = rng.uniform(-1, 1, shape) * mask
    diag = rng.uniform(0.5, 2.0, shape)
    x = rng.uniform(-3, 3, shape) * mask
    arrays = [a.astype(dtype) for a in (b, c_up, c_down, c_lat, diag)]
    return arrays + [np.zeros((), np.float64)], x.astype(dtype), mask


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-6), ("float64", 1e-13)])
def test_stencil_apply_matches_jax(dtype, rtol):
    """The CG matvec's stencil: f32 rel 1e-6, f64 rel 1e-13 (with a floor
    of rtol x max|value| where terms cancel)."""
    arrays, x, _ = seeded_system((6, 9, 11), dtype, seed=1)
    j = JW.stencil_apply(JW.LinearSystem(*(_j(a) for a in arrays)), _j(x))
    t = TW.stencil_apply(TW.LinearSystem(*(_t(a) for a in arrays)), _t(x))
    assert dtype_name(t) == dtype_name(j) == dtype
    a = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), a, rtol=rtol,
                               atol=rtol * float(np.abs(a).max()))


@pytest.mark.parametrize("shape", [(7, 3, 2), (11, 6, 5)])
def test_tridiag_vertical_solve_matches_jax_and_dense(shape):
    """The line preconditioner's Thomas elimination (float64): against JAX
    to rel 1e-12, and against a dense solve of every column to 1e-12
    (tests/test_cg_solver.py's check); masked columns (zero couplings)
    give z = rhs."""
    rng = np.random.default_rng(sum(shape))
    L, R, C = shape
    cu = np.zeros(shape)
    cd = np.zeros(shape)
    cu[1:] = rng.uniform(0, 0.45, (L - 1, R, C))
    cd[:-1] = rng.uniform(0, 0.45, (L - 1, R, C))
    cu[:, 0, 0] = cd[:, 0, 0] = 0.0                  # a masked-out column
    rhs = rng.normal(size=shape)
    j = np.asarray(JW.tridiag_vertical_solve(_j(cu), _j(cd), _j(rhs)))
    z = TW.tridiag_vertical_solve(_t(cu), _t(cd), _t(rhs)).numpy()
    np.testing.assert_allclose(z, j, rtol=1e-12, atol=1e-12 * np.abs(j).max())
    np.testing.assert_array_equal(z[:, 0, 0], rhs[:, 0, 0])
    for r in range(R):
        for c in range(C):
            Tm = np.eye(L)
            for layer in range(1, L):
                Tm[layer, layer - 1] = -cu[layer, r, c]
            for layer in range(L - 1):
                Tm[layer, layer + 1] = -cd[layer, r, c]
            np.testing.assert_allclose(Tm @ z[:, r, c], rhs[:, r, c], atol=1e-12)


def _assembled(fast):
    """One assembled system of the seeded problems: the float32 psi form
    (tests/test_torch_water.py's case, valley_dem(10)) or the float64 head
    form (tests/test_torch_f64.py's)."""
    if fast:
        jp, tp, jg, tg, psi, psi_old, sink, pond = seeded_case(seed=3, n=10)
        se = JW.compute_se_psi(jg, jp, _j(psi))
        sj, *_ = JW.assemble_fast(jg, jp, _j(psi), _j(psi_old), se, _j(sink),
                                  _j(pond), jnp.asarray(1, jnp.int32),
                                  jnp.asarray(60.0))
        x0 = psi
    else:
        jp, tp, jg, tg, h, h_old = seeded_heads(seed=9)
        se = JW.compute_se(jg, jp, _j(h))
        cap, k = JW.compute_capacity(jg, jp, _j(h), _j(h_old), se)
        flow, _ = JW.update_boundary_water(
            jg, jp, _j(h), _j(h_old), k, jnp.zeros_like(k),
            jnp.full(jg.shape[1:], 0.002), jnp.asarray(60.0))
        sj = JW.assemble_system(jg, jp, _j(h), _j(h_old), k, flow, cap,
                                jnp.full(jg.shape[1:], 0.002),
                                jnp.asarray(1), jnp.asarray(60.0))
        x0 = h
    return jp, tp, jg, tg, sj, x0


@pytest.mark.parametrize("precond", ["diag", "line"])
@pytest.mark.parametrize("fast", [True, False], ids=["psi_f32", "head_f64"])
def test_cg_solve_matches_jax(fast, precond, no_jacobi):
    """One CG solve of the same assembled system: the same iteration count
    and divergence flag, x within rel 1e-5 (f32) or 1e-10 (f64) of
    max|x|."""
    jp, tp, jg, tg, sj, x0 = _assembled(fast)
    over = dict(inner_solver="cg", cg_precond=precond)
    jp = J.SolverParameters.fast_f32(**over) if fast else J.SolverParameters(**over)
    tp = T.SolverParameters.fast_f32(**over) if fast else T.SolverParameters(**over)
    max_iter = tp.max_iterations_for(3)
    tol = max(tp.residual_tolerance, 1e-7) if fast else tp.residual_tolerance
    xj, dj, nj = jax.jit(lambda s, x: JSt._cg_solve(
        s, x, jg, jp, max_iter, tol, psi_form=fast))(sj, _j(x0))
    st = TW.LinearSystem(*(_t(a) for a in sj))
    xt, dt_, nt = TSt._cg_solve(st, _t(x0), tg, tp, max_iter, tol, psi_form=fast)
    print(f"cg {precond} fast={fast}: port {nt} it, jax {int(nj)} it, "
          f"diverged {dt_}/{bool(dj)}")
    assert nt == int(nj) and dt_ == bool(dj)
    assert 0 < nt < max_iter
    assert dtype_name(xt) == dtype_name(xj)
    a = np.asarray(xj)
    rtol = 1e-5 if fast else 1e-10
    np.testing.assert_allclose(xt.numpy(), a, rtol=0,
                               atol=rtol * float(np.abs(a).max()))


def _hour(kw, fast, period=3600.0, **problem):
    mk = (lambda m: m.SolverParameters.fast_f32(**kw)) if fast \
        else (lambda m: m.SolverParameters(**kw))
    jp, tp = mk(J), mk(T)
    jg, tg = build_grids(valley_dem(10))
    js, ts = rain_states(jg, jp, tg, tp, **(problem or dict(psi0=-1.5,
                                                            rain_mm_h=15.0)))
    jout, jstats = j_period_stats(jg, jp, js, period)
    tout, tstats = T.compute_period_stats(tg, tp, ts, period)
    jstats = tuple(int(s) for s in jstats)
    dh = float(np.abs(tout.h.numpy() - np.asarray(jout.h)).max())
    mbr_t, mbr_j = float(tout.balance_whole.mbr), float(jout.balance_whole.mbr)
    print(f"{kw} fast={fast}: port {tstats} jax {jstats} max|dh| {dh} m "
          f"MBR port {mbr_t} jax {mbr_j}")
    return jg, jout, jstats, tout, tstats, mbr_j, mbr_t


@pytest.mark.parametrize("precond", ["diag", "line"])
def test_cg_f64_hour_matches_jax(precond, no_jacobi):
    """SolverParameters(inner_solver="cg") free-running on tests/test_fast_f32.py's
    problem: identical stats, heads within 1e-9 m."""
    _, jout, jstats, tout, tstats, mbr_j, mbr_t = _hour(
        dict(inner_solver="cg", cg_precond=precond), fast=False)
    assert tstats == jstats
    np.testing.assert_allclose(tout.h.numpy(), np.asarray(jout.h), rtol=0,
                               atol=1e-9)
    assert mbr_t == pytest.approx(mbr_j, abs=1e-9)


@pytest.mark.parametrize("precond", ["line", "diag"])
def test_cg_fast_hour_matches_jax(precond, no_jacobi):
    """fast_f32() (CG line, the production preset) and fast_f32(cg_precond=
    "diag"), free-running: identical stats, heads within 1e-4 m, MBR within
    1e-6 and |MBR| < 2e-3."""
    _, jout, jstats, tout, tstats, mbr_j, mbr_t = _hour(
        dict(cg_precond=precond), fast=True)
    assert tstats == jstats
    np.testing.assert_allclose(tout.h.numpy(), np.asarray(jout.h), rtol=0,
                               atol=1e-4)
    assert mbr_t == pytest.approx(mbr_j, abs=1e-6)
    assert abs(mbr_t) < 2e-3


@pytest.mark.parametrize("precond", ["line", "diag"])
def test_cg_fast_locked_dt_matches_jax(precond, no_jacobi):
    """fast_f32() CG with dt locked at 60 s: steps, attempts,
    approximations and CG iterations identical; heads within 1e-4 m."""
    _, jout, jstats, tout, tstats, mbr_j, mbr_t = _hour(
        dict(cg_precond=precond, delta_t_min=60.0, delta_t_max=60.0), fast=True)
    assert tstats[:3] == jstats[:3] == (60, 60, tstats[2])
    assert tstats[3] == jstats[3]
    np.testing.assert_allclose(tout.h.numpy(), np.asarray(jout.h), rtol=0,
                               atol=1e-4)
    assert mbr_t == pytest.approx(mbr_j, abs=1e-6)


def test_cg_ponding_storm_matches_jax(no_jacobi):
    """tests/test_cg_solver.py's ponding storm (60 mm/h on a low-K soil,
    SolverParameters(inner_solver="cg"), float64 with the diagonal
    preconditioner): the surface clamp runs once per solve on most cells.
    Identical stats, heads within 1e-9 m, |MBR| < 2e-3, and it ponds."""
    soil = dict(vg_alpha=1.0, vg_n=1.3, vg_he=0.02, theta_s=0.40,
                theta_r=0.06, k_sat=2e-7)
    jp = J.SolverParameters(inner_solver="cg")
    tp = T.SolverParameters(inner_solver="cg")
    dem = valley_dem(10)
    jg = J.Grid.build(dem, 10.0, J.SoilFields.uniform(dem.shape, **soil),
                      total_depth=0.5)
    tg = T.Grid.build(dem, 10.0, T.SoilFields.uniform(dem.shape, device="cpu",
                                                      **soil),
                      total_depth=0.5, device="cpu")
    js, ts = rain_states(jg, jp, tg, tp, psi0=-0.5, rain_mm_h=60.0)
    jout, jstats = j_period_stats(jg, jp, js, 3600.0)
    tout, tstats = T.compute_period_stats(tg, tp, ts, 3600.0)
    jstats = tuple(int(s) for s in jstats)
    dh = float(np.abs(tout.h.numpy() - np.asarray(jout.h)).max())
    print(f"ponding storm: port {tstats} jax {jstats} max|dh| {dh} m")
    assert tstats == jstats
    np.testing.assert_allclose(tout.h.numpy(), np.asarray(jout.h), rtol=0,
                               atol=1e-9)
    surf = (tout.h[0] - tg.z[0])[tg.mask[0]].numpy()
    assert (surf > 0.001).mean() > 0.5
    assert abs(float(tout.balance_whole.mbr)) < 2e-3

"""The port's interpolation library (physics/fitting.py, detrending.py,
kriging.py) against the JAX package, on tests/test_detrending.py's inputs.

Each test feeds the same seeded numpy inputs to both packages (the port on
the CPU). Tolerances, and why:

- ``jnp.linspace`` (as XLA:CPU fuses it), ``first_guess_grid``, the lapse
  functions and their Jacobians (also at the knees and at ``p2 == 10``),
  the glocal weight maps (float32 counts of 0/1 terms) and the
  topographic distances: bit-equal, since each is the same IEEE
  operations in the same order;
- maps and values through the Levenberg-Marquardt fits: rel 1e-9 (the
  jitted JAX loop contracts multiply-adds and sums in its own order, and
  60 iterations carry that), with the cells whose winning fit differs
  counted (``start flips``): 8 of the 36 cells of the local map, each a
  tie of SSEs within 9.4e-16 between fits of one straight line (knees
  anywhere when both slopes are equal), with the same map value; a
  cell's fitted parameters rel 1e-7 and its curve at its stations rel
  1e-8, since 40 iterations leave a knee in a flat SSE valley (measured
  1.8e-8 and 1.7e-9);
- everything else that is float64 arithmetic with no decision on the way
  (linear fits, residuals, variograms): rel 1e-12 (LOO residuals of the
  values' scale: an outlier's neighbours sit near 0); station distances
  1 ulp (torch's vectorised float64 sqrt on the CPU is not correctly
  rounded in ~1% of lanes, XLA's is); a kriging map within 64 eps x
  cond(V) of its largest value, the forward error of a backward-stable
  LU (cond 5.4e2 to 1.4e10 here);
- chosen models (variogram mode, Kh): equal.
"""

import dataclasses
import math
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from criteria3d_tpu.physics import detrending as JD
from criteria3d_tpu.physics import fitting as JF
from criteria3d_tpu.physics import kriging as JK
from criteria3d_tpu_torch import convert, ops
from criteria3d_tpu_torch.physics import detrending as TD
from criteria3d_tpu_torch.physics import fitting as TF
from criteria3d_tpu_torch.physics import kriging as TK
from tests.test_torch_core import to_arrays

torch.set_num_threads(1)
CPU = "cpu"
LM_RTOL = 1e-9
RTOL = 1e-12


def rel_err(a, b, floor=0.0) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert a.shape == b.shape
    if not a.size:
        return 0.0
    scale = np.maximum(np.abs(b), floor)
    diff = np.abs(a - b)
    return float(np.max(np.where(diff == 0, 0.0, diff / np.where(scale > 0, scale, 1.0))))


def np_(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def stations(n=30, seed=0):
    """tests/test_detrending.py's ``_stations``."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 50_000, n)
    y = rng.uniform(0, 50_000, n)
    z = rng.uniform(0, 2000, n)
    return x, y, z, rng


def known_lapse():
    """test_piecewise_two_recovers_known_lapse's 80 noisy stations."""
    rng = np.random.default_rng(1)
    z = rng.uniform(0, 2500, 80)
    true = np.where(z < 500, 0.005 * (z - 500) + 12.0, -0.0065 * (z - 500) + 12.0)
    return z, true + rng.normal(0, 0.05, 80)


FUNCS = {"lapse_piecewise_two": 4, "lapse_piecewise_three": 5,
         "lapse_piecewise_three_free": 6}


# ---------------------------------------------------------------------------
# the arithmetic JAX's fits start from
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num", [2, 3, 4, 5, 6, 24])
def test_linspace_matches_jax_bitwise(num):
    """ops.linspace reproduces XLA:CPU's fused jnp.linspace bit for bit,
    over magnitudes from 1e-3 to 1e30 (the bounds' ``big``)."""
    rng = np.random.default_rng(num)
    for scale in (1e-3, 1.0, 2500.0, 1e30):
        a = rng.uniform(-1, 1, 60) * scale
        b = rng.uniform(-1, 1, 60) * scale
        t = np_(ops.linspace(torch.tensor(a), torch.tensor(b), num))
        j = np.stack([np.asarray(jnp.linspace(x, y, num)) for x, y in zip(a, b)])
        np.testing.assert_array_equal(t, j)


def test_fma_is_exact():
    """ops.fma rounds a * b + c once (exact rational reference), also
    where the sum cancels the product."""
    rng = np.random.default_rng(5)
    a, b, c = (rng.uniform(-1e3, 1e3, 3000) * 10.0 ** rng.integers(-20, 20, 3000)
               for _ in range(3))
    for cc in (c, -a * b):
        got = np_(ops.fma(torch.tensor(a), torch.tensor(b), torch.tensor(cc)))
        want = [float(Fraction(x) * Fraction(y) + Fraction(z)) for x, y, z in zip(a, b, cc)]
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_par", [4, 5, 6])
def test_first_guess_grid_bit_equal(n_par):
    """The default grid (5, 4 or 3 steps a parameter) of
    multiple_detrending's bounds, bit-equal, in itertools.product order."""
    z, obs = known_lapse()
    opt = JD.DetrendingOptions(elevation_function=[
        k for k, v in JF.ELEVATION_FUNCTIONS.items() if v[1] == n_par][0])
    lo, hi = JD._elevation_bounds(jnp.asarray(z), jnp.asarray(obs),
                                  jnp.ones(80, bool), opt)
    j = np.asarray(JF.first_guess_grid(lo, hi))
    t = np_(TF.first_guess_grid(np.asarray(lo), np.asarray(hi), device=CPU))
    np.testing.assert_array_equal(t, j)


def test_first_guess_grid_batched_two_steps():
    """The local map's 2-step grid over a batch of per-cell bounds equals
    JAX's vmapped grid bit for bit."""
    rng = np.random.default_rng(11)
    lo = rng.uniform(-50, 50, (7, 4))
    hi = lo + rng.uniform(0, 100, (7, 4))
    j = np.asarray(jax.vmap(lambda a, b: JF.first_guess_grid(a, b, 2))(lo, hi))
    np.testing.assert_array_equal(np_(TF.first_guess_grid(lo, hi, 2, device=CPU)), j)


@pytest.mark.parametrize("name", list(FUNCS))
def test_lapse_function_and_jacobian_at_ties(name):
    """Values and the analytic Jacobian against ``jax.jacfwd`` on both sides
    of each knee, exactly at them, and with ``p2`` at its bound 10 (JAX's
    ``maximum`` then splits the derivative 0.5 / 0.5): bit-equal."""
    n = FUNCS[name]
    jf, tf = getattr(JF, name), getattr(TF, name)
    x = np.array([0.0, 499.99, 500.0, 500.01, 505.0, 510.0, 510.0 + 1e-9, 800.0,
                  800.0001, 2000.0])
    for p2 in (10.0, 9.0, 300.0):
        p = np.array([500.0, 10.0, p2, -0.002, 0.004, -0.007])[:n]
        fj = np.asarray(jf(jnp.asarray(x), jnp.asarray(p)))
        np.testing.assert_array_equal(np_(tf(torch.tensor(x), torch.tensor(p))), fj)
        jj = np.asarray(jax.jacfwd(lambda q: jf(jnp.asarray(x), q))(jnp.asarray(p)))
        jt = np_(tf.jacobian(torch.tensor(x), torch.tensor(p)))
        np.testing.assert_array_equal(jt, jj)
    jl = np.asarray(jax.jacfwd(lambda q: JF.linear_intercept(jnp.asarray(x), q))(
        jnp.asarray([0.3, -2.0])))
    np.testing.assert_array_equal(
        np_(TF.linear_intercept.jacobian(torch.tensor(x), torch.tensor([0.3, -2.0]))), jl)


# ---------------------------------------------------------------------------
# fitting
# ---------------------------------------------------------------------------

def test_levenberg_marquardt_matches_jax():
    """One start, 60 iterations, with zero-weight stations: rel 1e-9."""
    z, obs = known_lapse()
    w = np.ones(80)
    w[::7] = 0.0
    pmin = np.array([0.0, 0.0, -0.05, -0.05])
    pmax = np.array([2500.0, 30.0, 0.05, 0.05])
    p0 = np.array([1200.0, 5.0, 0.01, -0.01])
    pj, sj = JF.levenberg_marquardt(JF.lapse_piecewise_two, p0, pmin, pmax, z, obs, 60, w)
    pt, st = TF.levenberg_marquardt(TF.lapse_piecewise_two, p0, pmin, pmax, z, obs, 60, w,
                                    device=CPU)
    assert rel_err(np_(pt), pj) <= LM_RTOL
    assert rel_err(np_(st), sj) <= LM_RTOL


@pytest.mark.parametrize("name", ["lapse_piecewise_two", "lapse_piecewise_three_free"])
def test_best_fitting_marquardt_matches_jax(name):
    """Every start of the default grid in one batch (625 / 729 starts): a
    winning start whose fit is JAX's, parameters and r2 rel 1e-9."""
    z, obs = known_lapse()
    n = FUNCS[name]
    pmin = np.array([0.0, 0.0, 10.0, -0.05, -0.05, -0.05])[:n]
    pmax = np.array([2500.0, 30.0, 2500.0, 0.05, 0.05, 0.05])[:n]
    if n == 4:
        pmin[2], pmax[2] = -0.05, 0.05
    jf, tf = getattr(JF, name), getattr(TF, name)
    pj, rj = JF.best_fitting_marquardt(jf, pmin, pmax, z, obs)
    pt, rt, best = TF.best_fitting_marquardt(tf, pmin, pmax, z, obs, device=CPU,
                                             return_start=True)
    params_j, sse_j = jax.vmap(lambda p0: JF.levenberg_marquardt(
        jf, p0, pmin, pmax, z, obs, 60, jnp.ones(80)))(JF.first_guess_grid(pmin, pmax))
    # many starts reach the same minimum, so the first of the equal SSEs
    # is a matter of rounding: the port's winner must be one of JAX's
    # minima (SSE rel 1e-9) with JAX's fit
    sse_j = np.asarray(sse_j)
    assert sse_j[int(best)] == pytest.approx(sse_j.min(), rel=LM_RTOL)
    assert rel_err(np.asarray(params_j)[int(best)], pj) <= LM_RTOL
    assert rel_err(np_(pt), pj) <= LM_RTOL
    assert rel_err(np_(rt), rj) <= LM_RTOL


def test_weighted_multilinear_matches_jax():
    rng = np.random.default_rng(2)
    X = rng.normal(size=(40, 2))
    y = 3.0 * X[:, 0] - 1.5 * X[:, 1] + 0.7 + rng.normal(0, 0.1, 40)
    w = rng.uniform(0, 1, 40)
    sj, ij = JF.weighted_multilinear(X, y, w)
    st, it = TF.weighted_multilinear(X, y, w, device=CPU)
    assert rel_err(np_(st), sj) <= RTOL and rel_err(np_(it), ij) <= RTOL


# ---------------------------------------------------------------------------
# multiple detrending
# ---------------------------------------------------------------------------

def _assert_models(tm, jm, rtol):
    assert tm.elevation_function == jm.elevation_function
    assert bool(tm.elevation_significant) == bool(jm.elevation_significant)
    np.testing.assert_array_equal(np_(tm.linear_significant), np.asarray(jm.linear_significant))
    for f in ("elevation_params", "linear_slopes", "linear_intercept"):
        assert rel_err(np_(getattr(tm, f)), getattr(jm, f)) <= rtol, f
    # r2 is a fraction of 1: rounding residue near 0 is held against 1
    assert rel_err(np_(tm.elevation_r2), jm.elevation_r2, 1.0) <= rtol


def test_multiple_detrending_elevation_and_proxy_matches_jax():
    """test_multiple_detrending_elevation_and_proxy's 60 stations with a
    sea-distance proxy and two NODATA stations: detrended values and every
    model field rel 1e-9, flags equal; the retrend at the stations too."""
    x, y, z, rng = stations(60, seed=3)
    sea = rng.uniform(0, 100_000, 60)
    v = 25.0 - 0.0065 * z + 2e-5 * sea + rng.normal(0, 0.02, 60)
    v[4] = JD.NODATA
    sea[9] = JD.NODATA
    dj, mj = JD.multiple_detrending(v, z, other_proxies=[sea])
    dt, mt = TD.multiple_detrending(v, z, other_proxies=[sea], device=CPU)
    assert bool(mt.elevation_significant)
    assert rel_err(np_(dt), dj) <= LM_RTOL
    _assert_models(mt, mj, LM_RTOL)
    rj = np.asarray(JD.retrend_map(mj, z, [sea]))
    assert rel_err(np_(TD.retrend_map(mt, z, [sea], device=CPU)), rj) <= LM_RTOL


def test_multiple_detrending_insignificant_elevation_matches_jax():
    x, y, z, rng = stations(30, seed=4)
    z_flat = np.full_like(z, 100.0)
    v = rng.normal(10, 1.0, 30)
    dj, mj = JD.multiple_detrending(v, z_flat)
    dt, mt = TD.multiple_detrending(v, z_flat, device=CPU)
    assert not bool(mt.elevation_significant)
    np.testing.assert_array_equal(np_(dt), np.asarray(dj))
    _assert_models(mt, mj, LM_RTOL)


def test_models_carried_across_both_ways():
    """A JAX-fitted model retrended and used in loo_residuals by the port,
    and a port-fitted model retrended by JAX: rel 1e-12 (the same model,
    so no fit in between); the variogram model round-trips equal."""
    x, y, z, rng = stations(60, seed=3)
    sea = rng.uniform(0, 100_000, 60)
    v = 25.0 - 0.0065 * z + 2e-5 * sea + rng.normal(0, 0.02, 60)
    _, mj = JD.multiple_detrending(v, z, other_proxies=[sea])
    mt = convert.trend_model_from_arrays(to_arrays(mj), device=CPU)
    _assert_models(mt, mj, 0.0)
    gz = np.linspace(0.0, 2500.0, 48).reshape(6, 8)
    gs = np.linspace(0.0, 1e5, 48).reshape(6, 8)
    assert rel_err(np_(TD.retrend_map(mt, gz, [gs], device=CPU)),
                   JD.retrend_map(mj, gz, [gs])) <= RTOL
    lj = np.asarray(JD.loo_residuals(x, y, z, v, detrend_model=mj))
    assert rel_err(np_(TD.loo_residuals(x, y, z, v, detrend_model=mt, device=CPU)),
                   lj) <= RTOL
    _, mt2 = TD.multiple_detrending(v, z, other_proxies=[sea], device=CPU)
    back = convert.trend_model_arrays(mt2)
    mj2 = JD.TrendModel(**{k: (jnp.asarray(a) if k != "elevation_function" else a)
                           for k, a in back.items()})
    assert rel_err(np.asarray(JD.retrend_map(mj2, gz, [gs])),
                   np_(TD.retrend_map(mt2, gz, [gs], device=CPU))) <= RTOL
    vm = JK.VariogramModel(JK.EXPONENTIAL, 0.1, 2.0, 20_000.0)
    vt = convert.variogram_model_from_fields(dataclasses.asdict(vm))
    assert dataclasses.asdict(vt) == dataclasses.asdict(vm)


# ---------------------------------------------------------------------------
# local detrending
# ---------------------------------------------------------------------------

def lapse_field():
    """test_local_detrending_tracks_spatially_varying_lapse's inputs."""
    rng = np.random.default_rng(7)
    n = 80
    x = rng.uniform(0, 100_000, n)
    y = rng.uniform(0, 100_000, n)
    z = rng.uniform(0, 2000, n)
    v = 20.0 + (-0.005 - 0.003 * (x / 100_000)) * z
    gx, gy = np.meshgrid(np.linspace(20_000, 80_000, 6), np.linspace(20_000, 80_000, 6))
    return x, y, z, v, gx, gy, np.full_like(gx, 1000.0)


LOCAL_OPT = dict(min_points_local=15, n_lm_iterations=40)


def test_local_detrending_map_matches_jax():
    """The 6 x 6 map of test_local_detrending_tracks_spatially_varying_lapse
    (80 stations, k = 18, 16 starts, 40 iterations): rel 1e-9."""
    x, y, z, v, gx, gy, gz = lapse_field()
    mj = np.asarray(JD.local_detrending_map(x, y, z, v, gx, gy, gz,
                                            options=JD.DetrendingOptions(**LOCAL_OPT)))
    mt = np_(TD.local_detrending_map(x, y, z, v, gx, gy, gz,
                                     options=TD.DetrendingOptions(**LOCAL_OPT), device=CPU))
    assert rel_err(mt, mj) <= LM_RTOL


def test_local_fits_per_cell_match_jax_start_flips_counted():
    """Per cell, the fit of its selected neighbourhood (k nearest by a
    stable sort, weights, bounds): JAX's side through
    ``jax.vmap(best_fitting_marquardt)``, each start's fit through the
    vmapped starts. A start flip is a cell whose winning start in the port
    is not one with JAX's winning fit; flips are counted (8 measured, at
    SSE ties); r2 rel 1e-9, the fitted curves rel 1e-8, parameters 1e-7."""
    x, y, z, v, gx, gy, _ = lapse_field()
    k = int(math.ceil(LOCAL_OPT["min_points_local"] * 1.2))
    n_it = LOCAL_OPT["n_lm_iterations"]
    cx, cy = gx.ravel(), gy.ravel()
    d = np.sqrt((x[None] - cx[:, None]) ** 2 + (y[None] - cy[:, None]) ** 2)
    idx = np.argsort(d, axis=1, kind="stable")[:, :k]
    nd = np.take_along_axis(d, idx, 1)
    w = np.maximum(1.0 - nd / nd.max(1, keepdims=True), JD.EPSILON)
    vz, vv = z[idx], v[idx]
    valid = np.ones_like(vz, bool)
    opt = JD.DetrendingOptions(**LOCAL_OPT)
    lo, hi = jax.vmap(lambda a, b, m: JD._elevation_bounds(a, b, m, opt))(vz, vv, valid)
    f = JF.lapse_piecewise_two

    def jax_cell(lo_, hi_, vz_, vv_, w_):
        g = JF.first_guess_grid(lo_, hi_, 2)
        p, r2 = JF.best_fitting_marquardt(f, lo_, hi_, vz_, vv_, w_, first_guesses=g,
                                          n_iter=n_it)
        pall, sse = jax.vmap(lambda p0: JF.levenberg_marquardt(f, p0, lo_, hi_, vz_, vv_,
                                                               n_it, w_))(g)
        return p, r2, jnp.argmin(sse), sse, pall

    pj, rj, bj, sse_j, pall_j = map(np.asarray, jax.vmap(jax_cell)(lo, hi, vz, vv, w))
    lo, hi = np.asarray(lo), np.asarray(hi)
    pt, rt, bt = TF.best_fitting_marquardt(
        TF.lapse_piecewise_two, lo, hi, vz, vv, w,
        first_guesses=TF.first_guess_grid(lo, hi, 2, device=CPU), n_iter=n_it,
        device=CPU, return_start=True)
    # a start flip: the port's winning start is not one whose fit is JAX's
    # winning fit (starts that reach one minimum tie within rounding, and
    # either is JAX's fit)
    bt = np_(bt)
    same_fit = np.array([rel_err(pall_j[c, bt[c]], pj[c]) <= LM_RTOL
                         for c in range(len(bt))])
    flips = np.nonzero(~same_fit)[0]
    gaps = np.array([abs(sse_j[c, bj[c]] - sse_j[c, bt[c]]) for c in flips])
    # measured: 8 flips (cells 5, 16, 17, 20, 21, 23, 24, 32), SSE gaps
    # <= 9.4e-16; each is the same straight line through the cell's
    # stations (equal slopes, the knee anywhere): the same values there
    assert len(flips) <= 8, f"start flips at cells {flips}, SSE gaps {gaps}"
    assert np.all(gaps <= 1e-12 * np.abs(sse_j.min(1)[flips]).clip(1e-3))
    # every cell: the fitted curve at its stations rel 1e-8 (the knee of
    # a straight line is not determined, so a flip's parameters are not
    # held); the other cells' parameters rel 1e-7: 40 iterations leave one
    # knee in a flat valley of the SSE, where the rounding moves it
    # (measured 1.8e-8 of its height, 3.5e-5 m; the curve 1.7e-9; the
    # map, test_local_detrending_map_matches_jax, 1.3e-10)
    curve_t = np_(TF.lapse_piecewise_two(torch.tensor(vz), pt[:, None, :]))
    curve_j = np.asarray(jax.vmap(JF.lapse_piecewise_two)(jnp.asarray(vz), pj))
    assert rel_err(curve_t, curve_j) <= 1e-8
    assert rel_err(np_(pt)[same_fit], pj[same_fit]) <= 1e-7
    assert rel_err(np_(rt), rj, 1.0) <= LM_RTOL


def test_local_detrending_lattice_ties_keep_station_order():
    """Stations on a 300 m lattice and cells at lattice centres, each
    equidistant from 4 (and more) stations: the k nearest are JAX's
    ``top_k`` choice (lower index first among ties), and the map matches
    rel 1e-9."""
    sx, sy = np.meshgrid(np.arange(6) * 300.0, np.arange(6) * 300.0)
    sx, sy = sx.ravel(), sy.ravel()
    rng = np.random.default_rng(21)
    sz = rng.uniform(100.0, 900.0, sx.size)
    sv = 15.0 - 0.006 * sz + rng.normal(0, 0.05, sx.size)
    gx, gy = np.meshgrid(np.arange(5) * 300.0 + 150.0, np.arange(5) * 300.0 + 150.0)
    gz = np.full_like(gx, 500.0)
    opt = dict(min_points_local=5, n_lm_iterations=20)
    k = int(math.ceil(5 * 1.2))
    d = np.sqrt((sx[None] - gx.ravel()[:, None]) ** 2 + (sy[None] - gy.ravel()[:, None]) ** 2)
    _, j_idx = jax.vmap(lambda dd: jax.lax.top_k(-dd, k))(jnp.asarray(d))
    np.testing.assert_array_equal(np.argsort(d, 1, kind="stable")[:, :k], np.asarray(j_idx))
    mj = np.asarray(JD.local_detrending_map(sx, sy, sz, sv, gx, gy, gz,
                                            options=JD.DetrendingOptions(**opt)))
    mt = np_(TD.local_detrending_map(sx, sy, sz, sv, gx, gy, gz,
                                     options=TD.DetrendingOptions(**opt), device=CPU))
    assert rel_err(mt, mj) <= LM_RTOL


def test_local_detrending_chunks_change_no_value(monkeypatch):
    """Cells are independent: the map in chunks of 7 cells equals the map
    in one batch bit for bit."""
    x, y, z, v, gx, gy, gz = lapse_field()
    opt = TD.DetrendingOptions(min_points_local=15, n_lm_iterations=10)
    whole = np_(TD.local_detrending_map(x, y, z, v, gx, gy, gz, options=opt, device=CPU))
    monkeypatch.setattr(TD, "_LOCAL_CHUNK", 7)
    np.testing.assert_array_equal(
        np_(TD.local_detrending_map(x, y, z, v, gx, gy, gz, options=opt, device=CPU)), whole)


# ---------------------------------------------------------------------------
# glocal
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [3.0, 5.0])
def test_glocal_weight_maps_bit_equal(window):
    """test_glocal_weight_maps_partition_of_unity's zones (an invalid
    cell, a third zone in a corner): float32 weights bit-equal."""
    zones = np.ones((20, 20), np.int32)
    zones[:, 10:] = 2
    zones[15:, 15:] = 3
    zones[0, 0] = 0
    j = np.asarray(JD.glocal_weight_maps(zones, window_width=window, cellsize=1.0))
    t = np_(TD.glocal_weight_maps(zones, window_width=window, cellsize=1.0, device=CPU))
    assert t.dtype == j.dtype == np.float32
    np.testing.assert_array_equal(t, j)


def test_glocal_detrending_matches_jax():
    """test_glocal_detrending_blends_area_models' two regimes and areas:
    rel 1e-9."""
    rng = np.random.default_rng(8)
    n = 60
    x = np.concatenate([rng.uniform(0, 45_000, n // 2), rng.uniform(55_000, 100_000, n // 2)])
    y = rng.uniform(0, 100_000, n)
    z = rng.uniform(0, 1500, n)
    v = np.where(x < 50_000, 20.0 - 0.004 * z, 24.0 - 0.008 * z)
    zones = np.ones((10, 10), np.int32)
    zones[:, 5:] = 2
    gx, gy = np.meshgrid(np.arange(10) * 10_000.0 + 5_000.0, np.arange(10) * 10_000.0 + 5_000.0)
    gz = np.full_like(gx, 800.0)
    areas = [np.nonzero(x < 50_000)[0], np.nonzero(x >= 50_000)[0]]
    wj = JD.glocal_weight_maps(zones, window_width=2.0, cellsize=10_000.0)
    mj = np.asarray(JD.glocal_detrending_map(x, y, z, v, gx, gy, gz, area_stations=areas,
                                             area_weights=wj))
    wt = TD.glocal_weight_maps(zones, window_width=2.0, cellsize=10_000.0, device=CPU)
    mt = np_(TD.glocal_detrending_map(x, y, z, v, gx, gy, gz, area_stations=areas,
                                      area_weights=wt, device=CPU))
    assert rel_err(mt, mj) <= LM_RTOL


# ---------------------------------------------------------------------------
# topographic distance + cross-validation
# ---------------------------------------------------------------------------

def ridge_case():
    """test_optimize_topo_kh_prefers_barrier_separation's stations and DEM."""
    rng = np.random.default_rng(9)
    n = 24
    x = np.concatenate([rng.uniform(0, 40_000, n // 2), rng.uniform(60_000, 100_000, n // 2)])
    y = rng.uniform(0, 10_000, n)
    z = np.full(n, 200.0)
    v = np.where(x < 50_000, 10.0, 20.0) + rng.normal(0, 0.1, n)
    dem = np.full((1, 101), 200.0)
    dem[0, 45:56] = 2000.0
    return x, y, z, v, dem


def test_topographic_distance_matches_jax():
    """The ridge and the flat DEM of test_topographic_distance_ridge, and a
    seeded 2-D DEM with NODATA cells over random segments: bit-equal."""
    dem = np.full((1, 101), 100.0)
    dem[0, 45:56] = 600.0
    for dm in (dem, np.full((1, 101), 100.0)):
        args = (dm, 0.0, 0.0, 100.0, 1, 500.0, 50.0, 100.0, 9500.0, 50.0, 100.0, 9000.0, 128)
        assert float(TD.topographic_distance(*args, device=CPU)) == \
            float(JD.topographic_distance(*args))
    rng = np.random.default_rng(17)
    dem2 = rng.uniform(0, 1500, (30, 40))
    dem2[rng.uniform(size=dem2.shape) < 0.05] = JD.NODATA
    for _ in range(20):
        x1, x2 = rng.uniform(0, 4000, 2)
        y1, y2 = rng.uniform(0, 3000, 2)
        z1, z2 = rng.uniform(0, 1500, 2)
        dist = math.hypot(x2 - x1, y2 - y1)
        args = (dem2, 0.0, 0.0, 100.0, 30, x1, y1, z1, x2, y2, z2, dist, 64)
        assert float(TD.topographic_distance(*args, device=CPU)) == \
            float(JD.topographic_distance(*args))


def test_topographic_distance_matrix_and_cv_match_jax():
    """The (n, n) topographic and plane distances bit-equal; LOO residuals
    and the CV error at several Kh rel 1e-12; the optimised Kh equal."""
    x, y, z, v, dem = ridge_case()
    tj, dj = JD.topographic_distance_matrix(dem, 0.0, 0.0, 1000.0, 1, x, y, z, max_steps=128)
    tt, dt = TD.topographic_distance_matrix(dem, 0.0, 0.0, 1000.0, 1, x, y, z, max_steps=128,
                                            device=CPU)
    np.testing.assert_array_equal(np_(tt), np.asarray(tj))
    assert rel_err(np_(dt), dj) <= 2.3e-16
    for kh in (0.0, 7.0, 64.0):
        rj = np.asarray(JD.loo_residuals(x, y, z, v, kh=kh, topo_dist=tj))
        assert rel_err(np_(TD.loo_residuals(x, y, z, v, kh=kh, topo_dist=tt, device=CPU)),
                       rj, np.abs(v).max()) <= RTOL
        ej = float(JD.cross_validation_error(x, y, z, v, kh=kh, topo_dist=tj))
        et = float(TD.cross_validation_error(x, y, z, v, kh=kh, topo_dist=tt, device=CPU))
        assert et == pytest.approx(ej, rel=RTOL)
    kj = JD.optimize_topo_kh(x, y, z, v, topo_dist=tj, max_kh=128.0)
    kt = TD.optimize_topo_kh(x, y, z, v, topo_dist=tt, max_kh=128.0, device=CPU)
    assert kt == kj and kt > 0


def test_loo_residuals_outlier_and_inactive_match_jax():
    """test_loo_residuals_flag_outlier's field, with NODATA and an inactive
    station: rel 1e-12 of the values' scale, NODATA where JAX puts it."""
    x, y, z, rng = stations(25, seed=10)
    v = np.full(25, 5.0)
    v[7] = 50.0
    v[3] = JD.NODATA
    active = np.ones(25, bool)
    active[11] = False
    rj = np.asarray(JD.loo_residuals(x, y, z, v, active=active))
    rt = np_(TD.loo_residuals(x, y, z, v, active=active, device=CPU))
    np.testing.assert_array_equal(rt == JD.NODATA, rj == JD.NODATA)
    assert rel_err(rt, rj, 50.0) <= RTOL


# ---------------------------------------------------------------------------
# kriging
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", [1, 2, 3, 4])
def test_variogram_models_match_jax(mode):
    h = np.linspace(0.0, 300.0, 61)
    mj = JK.VariogramModel(mode, nugget=0.2, sill=1.3, range_=100.0, slope=0.01)
    mt = TK.VariogramModel(mode, nugget=0.2, sill=1.3, range_=100.0, slope=0.01)
    assert mt.name == mj.name
    assert rel_err(np_(TK.variogram(h, mt, device=CPU)), JK.variogram(h, mj)) <= RTOL


def cosine_field():
    """test_variogram_fit_recovers_spherical's 150-station field."""
    rng = np.random.default_rng(13)
    n = 150
    x = rng.uniform(0, 50_000, n)
    y = rng.uniform(0, 50_000, n)
    v = np.zeros(n)
    for _ in range(40):
        kx, ky = rng.normal(0, 1.0 / 10_000.0, 2)
        ph = rng.uniform(0, 2 * np.pi)
        v += np.cos(kx * x + ky * y + ph)
    return x, y, v / np.sqrt(20)


def test_empirical_and_fitted_variogram_match_jax():
    """Bin centres and pair counts bit-equal, semivariances rel 1e-12; the
    fitted model (mode chosen from four, range from the 24-candidate
    linspace, bit-equal) the same mode and range, nugget and sill rel
    1e-12; also with an inactive station and a fixed max distance."""
    x, y, v = cosine_field()
    for kw in ({}, dict(max_distance=20_000.0, active=np.arange(150) != 4)):
        hj, gj, cj = JK.empirical_variogram(x, y, v, n_bins=15, **kw)
        ht, gt, ct = TK.empirical_variogram(x, y, v, n_bins=15, device=CPU, **kw)
        np.testing.assert_array_equal(np_(ht), np.asarray(hj))
        np.testing.assert_array_equal(np_(ct), np.asarray(cj))
        assert rel_err(np_(gt), gj) <= RTOL
        fj = JK.fit_variogram(hj, gj, cj)
        ft = TK.fit_variogram(hj, gj, cj, device=CPU)
        assert (ft.mode, ft.range_) == (fj.mode, fj.range_)
        assert ft.nugget == pytest.approx(fj.nugget, rel=RTOL, abs=1e-300)
        assert ft.sill == pytest.approx(fj.sill, rel=RTOL)
    # each mode alone: its own best range
    for mode in (1, 2, 3, 4):
        fj = JK.fit_variogram(hj, gj, cj, modes=(mode,))
        ft = TK.fit_variogram(hj, gj, cj, modes=(mode,), device=CPU)
        assert (ft.mode, ft.range_) == (fj.mode, fj.range_)
        assert ft.sill == pytest.approx(fj.sill, rel=RTOL)
        assert ft.slope == pytest.approx(fj.slope, rel=RTOL, abs=1e-300)


@pytest.mark.parametrize("case", ["exact", "weights_sum", "fitted", "inactive"])
def test_ordinary_kriging_matches_jax(case):
    """The three kriging tests of test_detrending.py: zero-nugget spherical
    at the stations, the exponential constant field with a NODATA station
    and the fitted (zero-nugget gaussian) model off the stations; and an
    exponential model of the same field with every seventh station
    inactive (identity rows); each map within 64 eps x cond(V) of its
    largest value."""
    active = None
    if case == "exact":
        x, y, z, rng = stations(20, seed=11)
        v = 1e-4 * x + rng.normal(0, 0.01, 20)
        args = dict(mode=JK.SPHERICAL, nugget=0.0, sill=4.0, range_=30_000.0)
        gx, gy = x, y
    elif case == "weights_sum":
        x, y, z, rng = stations(15, seed=12)
        v = np.full(15, 3.25)
        v[2] = JD.NODATA
        args = dict(mode=JK.EXPONENTIAL, nugget=0.1, sill=2.0, range_=20_000.0)
        gx, gy = np.meshgrid(np.linspace(0, 50_000, 7), np.linspace(0, 50_000, 7))
    elif case == "fitted":
        x, y, v = cosine_field()
        args = dataclasses.asdict(JK.fit_variogram(*JK.empirical_variogram(x, y, v, n_bins=15)))
        gx, gy = np.meshgrid(np.linspace(0, 50_000, 9), np.linspace(0, 50_000, 8))
    else:
        x, y, v = cosine_field()
        active = np.arange(x.size) % 7 != 3
        args = dict(mode=JK.EXPONENTIAL, nugget=0.05, sill=0.6, range_=15_000.0)
        gx, gy = np.meshgrid(np.linspace(0, 50_000, 9), np.linspace(0, 50_000, 8))
    ej = np.asarray(JK.ordinary_kriging(x, y, v, gx, gy, JK.VariogramModel(**args),
                                        active=active))
    et = np_(TK.ordinary_kriging(x, y, v, gx, gy, TK.VariogramModel(**args), active=active,
                                 device=CPU))
    assert et.shape == ej.shape
    ok = (v != JD.NODATA) & (True if active is None else active)
    d = np.hypot(x[ok, None] - x[None, ok], y[ok, None] - y[None, ok])
    V = np.ones((ok.sum() + 1,) * 2)
    V[:-1, :-1] = np.asarray(JK.variogram(d, JK.VariogramModel(**args)))
    V[-1, -1] = 0.0
    bound = 64 * np.finfo(float).eps * np.linalg.cond(V)
    assert np.abs(et - ej).max() <= bound * np.abs(ej).max()

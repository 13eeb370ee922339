"""The port's float32 psi-carry water physics against the JAX package: one
assembly (with a culvert and a prescribed node), saturation, mass balance
and the result dtypes, on the same seeded inputs."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import criteria3d_tpu as J
from criteria3d_tpu.solver import water as JW
import criteria3d_tpu_torch as T
from criteria3d_tpu_torch.solver import water as TW
from tests.test_catchment3d import valley_dem
from tests.test_torch_core import (build_grids, dtype_name, port_grid,
                                   rain_states)

torch.set_num_threads(1)

# Relative tolerance of one f32 assembly: both evaluate the same f32
# expressions, but log1p and a few of the powers differ by an ulp between
# XLA:CPU and torch, and the capacity secant (se_c - se_p)/dpsi magnifies
# an ulp by ~ se/(dse*dpsi); the seeded |dpsi| >= 0.02 m keeps that well
# under 1e-5.
RTOL = 1e-5


def seeded_case(seed=0, n=12, culvert_compat=True):
    """A grid with a culvert outlet and a prescribed node, and a seeded
    unsaturated/ponded psi-carry state (float32, as the Picard loop has it)."""
    kw = dict(use_pallas=True, culvert_reference_compat=culvert_compat)
    jp = J.SolverParameters.fast_f32(**kw)
    tp = T.SolverParameters.fast_f32(**kw)
    jg, _ = build_grids(valley_dem(n))
    jg = jg.set_culvert(n - 1, n // 2, roughness=0.02, slope=0.05,
                        width=1.0, height=0.5)
    jg = jg.set_prescribed(4, 5, 5, float(jg.z[4, 5, 5]) - 0.3)
    tg = port_grid(jg)
    rng = np.random.default_rng(seed)
    L, R, C = jg.shape
    mask = np.asarray(jg.mask)
    psi = rng.uniform(-2.5, 0.2, (L, R, C))
    psi[0] = rng.uniform(0.0, 0.6, (R, C))          # ponded surface
    psi[0, n - 1, n // 2] = 0.9                     # culvert: pressure flow
    step = rng.uniform(0.02, 0.15, (L, R, C)) * rng.choice([-1, 1], (L, R, C))
    psi_old = psi + step
    psi_old[0] = np.maximum(psi_old[0], 0.0)
    psi = np.where(mask, psi, 0.0).astype(np.float32)
    psi_old = np.where(mask, psi_old, 0.0).astype(np.float32)
    sink = np.zeros((L, R, C))
    sink[0] = np.where(mask[0], 0.02 * 100.0 / 3600.0, 0.0)
    sink[0, 3, 3] = -0.05                           # evaporation-limited
    pond = np.full((R, C), 0.002)
    return jp, tp, jg, tg, psi, psi_old, sink, pond


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype", ["float32", "bool"])
def test_shift2d_matches_jax(dtype):
    """Every lateral offset and the centre, on (L, R, C) and (R, C)
    inputs, with the default and a custom fill: bit-equal; MIRROR equal."""
    from criteria3d_tpu.solver import shifts as JS
    from criteria3d_tpu_torch.solver import shifts as TS
    rng = np.random.default_rng(11)
    fill = True if dtype == "bool" else -2.5
    for shape in ((3, 5, 7), (6, 4)):
        x = rng.uniform(-1, 1, shape)
        x = (x > 0) if dtype == "bool" else x.astype(np.float32)
        for di, dj in ((0, 0),) + TS.LATERAL_OFFSETS:
            for kw in ({}, dict(fill=fill)):
                j = np.asarray(JS.shift2d(_j(x), di, dj, **kw))
                t = TS.shift2d(_t(x), di, dj, **kw).numpy()
                assert t.dtype == j.dtype
                np.testing.assert_array_equal(t, j, err_msg=str((shape, di, dj, kw)))
    assert TS.MIRROR == JS.MIRROR


def test_power_matches_xla():
    """``core.soil.power`` (float32 powers evaluated in float64, rounded
    once) against XLA:CPU's float32 pow: within one ulp everywhere and
    bit-equal in at least 99.5% of elements; torch's own float32 pow is
    shown beside it (run with -s)."""
    from criteria3d_tpu_torch.core.soil import power
    rng = np.random.default_rng(7)
    x = rng.uniform(1e-6, 50.0, 200_000).astype(np.float32)
    y = rng.uniform(-3.0, 3.0, 200_000).astype(np.float32)
    ref = np.asarray(jnp.power(_j(x), _j(y)))
    ours = power(_t(x), _t(y)).numpy()
    plain = torch.pow(_t(x), _t(y)).numpy()
    same = float(np.mean(ours == ref))
    print(f"float32 pow bit-equal to XLA:CPU: power() {same}, "
          f"torch.pow {float(np.mean(plain == ref))}")
    assert same >= 0.995
    np.testing.assert_allclose(ours, ref, rtol=2.0 ** -23, atol=0)


@pytest.mark.parametrize("approx,culvert_compat", [(0, True), (1, False)])
def test_assemble_fast_matches_jax(approx, culvert_compat):
    """Both Picard branches (the approx-0 rainfall predictor) and both
    culvert water levels: the reference's 0.5*(H - Hold) - z, which keeps
    the culvert dry, and the averaged level, which runs its rating."""
    jp, tp, jg, tg, psi, psi_old, sink, pond = seeded_case(
        culvert_compat=culvert_compat)
    dt = 300.0
    se_j = JW.compute_se_psi(jg, jp, _j(psi))
    se_t = TW.compute_se_psi(tg, tp, _t(psi))
    np.testing.assert_allclose(se_t.numpy(), np.asarray(se_j), rtol=RTOL)

    sys_j, flow_j, rate_j, k_j = JW.assemble_fast(
        jg, jp, _j(psi), _j(psi_old), se_j, _j(sink), _j(pond),
        jnp.asarray(approx, jnp.int32), jnp.asarray(dt))
    sys_t, flow_t, rate_t, k_t = TW.assemble_fast(
        tg, tp, _t(psi), _t(psi_old), _t(np.asarray(se_j)), _t(sink),
        _t(pond), approx, dt)

    pairs = dict(b=(sys_j.b, sys_t.b), c_up=(sys_j.c_up, sys_t.c_up),
                 c_down=(sys_j.c_down, sys_t.c_down),
                 c_lat=(sys_j.c_lat, sys_t.c_lat), diag=(sys_j.diag, sys_t.diag),
                 courant=(sys_j.courant, sys_t.courant),
                 water_flow=(flow_j, flow_t), rate=(rate_j, rate_t), k=(k_j, k_t))
    for name, (j, t) in pairs.items():
        assert dtype_name(t) == dtype_name(j), name
        a = np.asarray(j)
        # atol: values that cancel to ~0 are held to rel 1e-5 of the field
        np.testing.assert_allclose(t.numpy(), a, rtol=RTOL,
                                   atol=RTOL * 1e-3 * float(np.abs(a).max()),
                                   err_msg=name)
    # the boundary branches really ran
    bt = np.asarray(jg.btype)
    if not culvert_compat:
        assert np.asarray(rate_j)[bt == int(J.BoundaryType.CULVERT)].min() < 0
    assert np.asarray(rate_j)[bt == int(J.BoundaryType.PRESCRIBED_TOTAL_POTENTIAL)].max() != 0
    assert float(sys_j.courant) > 0


def test_mass_balance_psi_matches_jax():
    jp, tp, jg, tg, psi, _, sink, _ = seeded_case(seed=1)
    se = JW.compute_se_psi(jg, jp, _j(psi))
    flow = (sink * 0.7).astype(np.float32)
    prev = 123.456
    bj = JW.current_mass_balance_psi(jg, jp, _j(psi), se, _j(flow),
                                     jnp.asarray(prev), jnp.asarray(120.0))
    bt = TW.current_mass_balance_psi(tg, tp, _t(psi), _t(np.asarray(se)),
                                     _t(flow), torch.tensor(prev,
                                                            dtype=torch.float64),
                                     120.0)
    for name, j, t in zip(("storage", "sink", "mbe", "mbr"), bj, bt):
        assert dtype_name(t) == dtype_name(j) == "float64", name
        # float64 sums of the same float32 values, in another order
        np.testing.assert_allclose(float(t), float(j), rtol=1e-12, err_msg=name)


@pytest.mark.parametrize("fast", [True, False])
def test_total_water_content_matches_jax(fast):
    """Both dtype branches: f32 theta summed in f64 (fast) and pure f64."""
    mk = (lambda m: m.SolverParameters.fast_f32(use_pallas=True)) if fast \
        else (lambda m: m.SolverParameters())
    jp, tp = mk(J), mk(T)
    jg, tg = build_grids(valley_dem(10))
    js, ts = rain_states(jg, jp, tg, tp, psi0=-0.8, rain_mm_h=0.0)
    h = np.asarray(js.h).copy()
    h[0] += np.where(np.asarray(jg.mask[0]), 0.01, 0.0)     # ponded surface
    se_j = JW.compute_se(jg, jp, _j(h))
    se_t = TW.compute_se(tg, tp, _t(h))
    assert dtype_name(se_t) == dtype_name(se_j) == "float64"
    np.testing.assert_allclose(se_t.numpy(), np.asarray(se_j),
                               rtol=3e-7 if fast else 1e-13)
    w_j = JW.total_water_content(jg, jp, _j(h), se_j)
    w_t = TW.total_water_content(tg, tp, _t(h), _t(np.asarray(se_j)))
    assert dtype_name(w_t) == dtype_name(w_j)
    np.testing.assert_allclose(float(w_t), float(w_j), rtol=1e-12)


def test_jacobi_sweep_psi_matches_jax():
    jp, tp, jg, tg, psi, psi_old, sink, pond = seeded_case(seed=2)
    se = JW.compute_se_psi(jg, jp, _j(psi))
    sys_j, *_ = JW.assemble_fast(jg, jp, _j(psi), _j(psi_old), se, _j(sink),
                                 _j(pond), jnp.asarray(0, jnp.int32),
                                 jnp.asarray(60.0))
    sys_t = TW.LinearSystem(*(_t(np.asarray(a)) for a in sys_j))
    xj, nj = JW.jacobi_sweep_psi(sys_j, _j(psi), jg, jg.n_nodes)
    xt, nt = TW.jacobi_sweep_psi(sys_t, _t(psi), tg, tg.n_nodes)
    assert dtype_name(xt) == dtype_name(xj) == "float32"
    scale = float(np.abs(np.asarray(xj)).max())
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                               atol=4 * 2.0 ** -23 * scale)
    assert float(nt) == pytest.approx(float(nj), rel=1e-5)


def test_water_state_dtypes_match_jax():
    """Every WaterState field dtype equals the JAX package's, before and
    after a step of the fast path."""
    jp = J.SolverParameters.fast_f32(use_pallas=True)
    tp = T.SolverParameters.fast_f32(use_pallas=True)
    jg, tg = build_grids(valley_dem(8))
    js, ts = rain_states(jg, jp, tg, tp, psi0=-1.0, rain_mm_h=20.0)
    js2, _ = J.compute_step(jg, jp, js, 600.0)
    ts2, _ = T.compute_step(tg, tp, ts, 600.0)
    for a, b in ((js, ts), (js2, ts2)):
        for f in dataclasses.fields(b):
            t, j = getattr(b, f.name), getattr(a, f.name)
            if dataclasses.is_dataclass(t):
                for g in dataclasses.fields(t):
                    assert dtype_name(getattr(t, g.name)) == \
                        dtype_name(getattr(j, g.name)), (f.name, g.name)
            else:
                assert dtype_name(t) == dtype_name(j), f.name

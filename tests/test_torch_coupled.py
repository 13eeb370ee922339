"""The port's coupled water + heat paths against the JAX package: the
coupled step on tests/test_coupled.py's 4 x 4 column, coupled hours on its
6 x 6 heat-parity column (float64 with and without vapor, ``fast_f32`` in
exact mode) and on its 1 x 1 column (``heat_frozen_props``), and a
``heat_advection`` hour on tests/test_heat.py's column.

Both implementations get the same numpy inputs (the JAX objects carried
across with ``convert``); the port runs on the CPU. The JAX coupled
functions are jitted: XLA folds divisions by constants into multiplications by
reciprocals and fuses the balance sums, so it differs from the same
functions run op by op by float ulps. Against JAX's op-by-op run
(``jax.disable_jit()``, tests/test_torch_coupled_opbyop.py and
test_torch_exact_opbyop.py) the port's float64 coupled step is bit-equal,
its ``heat_frozen_props`` hour has bit-equal T, and its float32 exact-mode
hour is 1.4e-3 K off; against jitted JAX the float64 paths agree to
~1e-11 and the float32 ones within the bars each test states.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import criteria3d_tpu as J
from criteria3d_tpu.constants import ZEROCELSIUS
from criteria3d_tpu.core.grid import BoundaryType as JBT
from criteria3d_tpu.solver import heat as JH
from criteria3d_tpu.solver.coupled import (compute_period_coupled as j_period,
                                           compute_step_coupled as j_step)
from criteria3d_tpu.solver.step import initialize_balance as j_ib
import criteria3d_tpu_torch as T
from criteria3d_tpu_torch import convert
from criteria3d_tpu_torch import problems as TP
from criteria3d_tpu_torch.solver import coupled as TC
from criteria3d_tpu_torch.solver import heat as TH
from tests.test_torch_core import port_grid, port_state, to_arrays

torch.set_num_threads(1)


def port_heat(jheat, jboundary):
    return (convert.heat_state_from_arrays(to_arrays(jheat), device="cpu"),
            convert.heat_boundary_from_arrays(to_arrays(jboundary), device="cpu"))


def jax_column(params, n=6, total_depth=0.6, mask_all=False):
    """tests/test_coupled.py's heat-parity column (n = 6) or its frozen-props
    column (n = 1, total_depth 0.8, boundary mask = layer-1 mask)."""
    dem = np.zeros((n, n)) + np.arange(n)[None, :] * 0.1
    soil = J.SoilFields.uniform((n, n), vg_alpha=1.4, vg_n=1.6, vg_he=0.02,
                                theta_s=0.43, theta_r=0.05, k_sat=1e-5)
    grid = J.Grid.build(dem, 2.0, soil, total_depth=total_depth,
                        free_catchment_runoff=False, free_bottom_drainage=False,
                        free_lateral_drainage=False)
    bt = np.asarray(grid.btype).copy()
    bs = np.asarray(grid.bsize).copy()
    bt[1][:] = int(JBT.HEAT_SURFACE)
    bs[1][:] = float(grid.area)
    grid = dataclasses.replace(grid, btype=jnp.asarray(bt), bsize=jnp.asarray(bs))
    water = j_ib(grid, params, J.WaterState.initialize(grid, params,
                                                       matric_potential=-2.0))
    heat = JH.initialize_heat(grid, 283.15)
    storage = JH.heat_storage(grid, params, heat, water)
    heat = dataclasses.replace(heat, storage_prev=storage, storage_whole=storage)
    mask = grid.mask[1] if mask_all else jnp.asarray(bt[1] == int(JBT.HEAT_SURFACE))
    boundary = JH.HeatBoundary.uniform(grid.shape[1:], air_temperature=298.15,
                                       rel_humidity=50.0, wind_speed=2.0,
                                       net_irradiance=300.0, mask=mask)
    return grid, water, heat, boundary


def run_both(jp, tp, setup, period=3600.0):
    """One coupled period in each package from the same inputs; returns
    ((jax water, jax heat), (port water, port heat), port counts, grid)."""
    grid, water, heat, boundary = setup(jp)
    jw, jh = j_period(grid, jp, water, heat, boundary, period)
    th, tb = port_heat(heat, boundary)
    TC.reset_counts()
    tw, tht = T.compute_period_coupled(port_grid(grid), tp, port_state(water),
                                       th, tb, period)
    return (jw, jh), (tw, tht), TC.counts(), grid


def assert_period(j, t, grid, jp, tp, *, dh, dT, rel, label):
    (jw, jh), (tw, th) = j, t
    mask = np.asarray(grid.mask)
    heat_mask = mask.copy()
    heat_mask[0] = False
    e_h = float(np.abs(tw.h.numpy() - np.asarray(jw.h))[mask].max())
    e_t = float(np.abs(th.t.numpy() - np.asarray(jh.t))[heat_mask].max())
    sj = float(JH.heat_storage(grid, jp, jh, jw))
    st = float(TH.heat_storage(port_grid(grid), tp, th, tw))
    mbr_j, mbr_t = float(jw.balance_whole.mbr), float(tw.balance_whole.mbr)
    print(f"{label}: max|dh| {e_h} m, max|dT| {e_t} K, heat storage {st} vs "
          f"{sj}, water MBR {mbr_t} vs {mbr_j}, heat sink {float(th.sink_whole)} "
          f"vs {float(jh.sink_whole)}")
    assert tw.h.dtype == th.t.dtype == torch.float64
    assert e_h <= dh and e_t <= dT
    assert st == pytest.approx(sj, rel=rel)
    # the water whole-period MBR is a small difference of two sums: held to
    # rel of the stored water
    storage = float(jw.balance_whole.storage)
    assert (abs(float(tw.balance_whole.mbe) - float(jw.balance_whole.mbe))
            <= rel * storage)
    assert mbr_t == pytest.approx(mbr_j, rel=rel, abs=rel * storage / 0.001)
    assert bool(torch.isfinite(th.t).all())


def test_compute_step_coupled_matches_jax():
    """Three coupled steps on tests/test_coupled.py's 4 x 4 column (5 mm/h
    of rain, 400 W/m2 and warm air over cool soil), float64: the same
    dt_water each step, h within 1e-9 m, T within 1e-8 K."""
    dem = np.full((4, 4), 100.0)
    soil = J.SoilFields.uniform(dem.shape, vg_alpha=1.2, vg_n=1.5, vg_he=0.02,
                                theta_s=0.41, theta_r=0.04, k_sat=5e-6)
    grid = J.Grid.build(dem, 2.0, soil, total_depth=0.5,
                        free_catchment_runoff=False)
    jp, tp = J.SolverParameters(), T.SolverParameters()
    water = j_ib(grid, jp, J.WaterState.initialize(grid, jp, matric_potential=-1.0))
    rain = 0.005 * float(grid.area) / 3600.0
    water = dataclasses.replace(water, sink_source=jnp.zeros_like(
        water.sink_source).at[0].set(jnp.where(grid.mask[0], rain, 0.0)))
    heat = JH.initialize_heat(grid, ZEROCELSIUS + 10.0)
    heat = dataclasses.replace(heat, storage_prev=JH.heat_storage(grid, jp, heat, water))
    boundary = JH.HeatBoundary.uniform(grid.shape[1:],
                                       air_temperature=ZEROCELSIUS + 25.0,
                                       net_irradiance=400.0)
    tg, tw = port_grid(grid), port_state(water)
    th, tb = port_heat(heat, boundary)
    jw, jh, t = water, heat, 0.0
    for _ in range(3):
        jw, jh, jdt = j_step(grid, jp, jw, jh, boundary, 3600.0 - t)
        tw, th, tdt = T.compute_step_coupled(tg, tp, tw, th, tb, 3600.0 - t)
        assert tdt == float(jdt)
        t += tdt
        np.testing.assert_allclose(tw.h.numpy(), np.asarray(jw.h), rtol=0, atol=1e-9)
        np.testing.assert_allclose(th.t.numpy(), np.asarray(jh.t), rtol=0, atol=1e-8)
    # the soil warmed and the rain went in, as the JAX test checks
    assert float(th.t[1].min()) > ZEROCELSIUS + 10.1
    assert float(tw.se[1].max()) > float(np.asarray(water.se[1]).max())


@pytest.mark.parametrize("vapor", [False, True], ids=["conduction", "vapor"])
def test_period_coupled_f64_matches_jax(vapor):
    """One coupled hour of the 6 x 6 heat-parity column, float64: h within
    1e-9 m, T within 1e-7 K; heat storage and water balance to rel 1e-9."""
    jp, tp = J.SolverParameters(heat_vapor=vapor), T.SolverParameters(heat_vapor=vapor)
    j, t, cnt, grid = run_both(jp, tp, jax_column)
    print(cnt)
    assert cnt["substeps_accepted"] >= cnt["chunks"] > 0 and cnt["heat_sweeps"] > 0
    assert_period(j, t, grid, jp, tp, dh=1e-9, dT=1e-7, rel=1e-9,
                  label=f"f64 vapor={vapor}")


def test_period_coupled_fast_matches_jax():
    """fast_f32(heat_vapor=True) in exact mode (per-sub-step properties,
    float32 assembly and sweeps, float64 balance) on the 6 x 6 column for
    one hour: h within 1e-4 m, T within 5e-3 K, heat storage and water
    balance to rel 1e-5.

    The T bar is JAX's own reproducibility on this hour, not the port's:
    the jitted JAX hour and the same hour run op by op
    (``jax.disable_jit()``) differ by 2.44e-3 K, because exact mode
    re-evaluates float32 properties at every sub-step and the 10-40 float32
    sweeps per sub-step stop at a 1e-5 K norm, so float32 ulps (XLA's
    reciprocal-folded divisions, a powf ulp) move each sub-step's endpoint.
    The port sits 1.4e-3 K from the op-by-op run and 2.3e-3 K from the
    jitted one; 5e-3 K is 10x inside JAX's float32-vs-float64 bar of
    0.05 K (tests/test_coupled.py); tests/test_torch_heat.py holds a single
    sub-step to 1e-4 K."""
    jp = J.SolverParameters.fast_f32(heat_vapor=True)
    tp = T.SolverParameters.fast_f32(heat_vapor=True)
    j, t, cnt, grid = run_both(jp, tp, jax_column)
    print(cnt)
    assert_period(j, t, grid, jp, tp, dh=1e-4, dT=5e-3, rel=1e-5, label="fast exact")


def test_period_coupled_frozen_props_matches_jax():
    """fast_f32(heat_vapor=True, heat_frozen_props=True) on
    tests/test_coupled.py's 1 x 1 column (total depth 0.8 m) for one hour:
    h within 1e-4 m, T within 1e-3 K, heat storage and water balance to
    rel 1e-5."""
    jp = J.SolverParameters.fast_f32(heat_vapor=True, heat_frozen_props=True)
    tp = T.SolverParameters.fast_f32(heat_vapor=True, heat_frozen_props=True)
    j, t, cnt, grid = run_both(
        jp, tp, lambda p: jax_column(p, n=1, total_depth=0.8, mask_all=True))
    print(cnt)
    assert cnt["chunks"] > 0
    assert_period(j, t, grid, jp, tp, dh=1e-4, dT=1e-3, rel=1e-5, label="frozen props")


def test_period_coupled_advection_matches_jax():
    """heat_advection (and vapor) on tests/test_heat.py's 4 x 4 column
    (depth 1 m, psi0 = -1 m, free drainage at the bottom) under 10 mm/h of
    rain and warm air, float64, 1800 s: the infiltration and drainage
    advection branches run; T within 1e-7 K, h within 1e-9 m."""
    def setup(p):
        dem = np.full((4, 4), 100.0)
        soil = J.SoilFields.uniform((4, 4), vg_alpha=1.2, vg_n=1.5, vg_he=0.02,
                                    theta_s=0.41, theta_r=0.04, k_sat=5e-6)
        grid = J.Grid.build(dem, 2.0, soil, total_depth=1.0,
                            free_catchment_runoff=False,
                            free_lateral_drainage=False)
        water = j_ib(grid, p, J.WaterState.initialize(grid, p, matric_potential=-1.0))
        rain = 0.010 * float(grid.area) / 3600.0
        water = dataclasses.replace(water, sink_source=jnp.zeros_like(
            water.sink_source).at[0].set(jnp.where(grid.mask[0], rain, 0.0)))
        heat = JH.initialize_heat(grid, ZEROCELSIUS + 5.0)
        storage = JH.heat_storage(grid, p, heat, water)
        heat = dataclasses.replace(heat, storage_prev=storage, storage_whole=storage)
        boundary = JH.HeatBoundary.uniform(grid.shape[1:],
                                           air_temperature=ZEROCELSIUS + 20.0,
                                           net_irradiance=100.0)
        return grid, water, heat, boundary

    kw = dict(heat_advection=True, heat_vapor=True)
    jp, tp = J.SolverParameters(**kw), T.SolverParameters(**kw)
    j, t, cnt, grid = run_both(jp, tp, setup, period=1800.0)
    print(cnt)
    assert_period(j, t, grid, jp, tp, dh=1e-9, dT=1e-7, rel=1e-9, label="advection")


def test_coupled_storm_matches_jax():
    """The coupled storm hour of chip_smoke.py phase 3e (bench.py's coupled
    leg: fast_f32 with vapor and heat_frozen_props, 20 mm/h on clay loam,
    every layer-1 node a HeatSurface) on the synthetic catchment cut to a
    48 box: problems.build_coupled_problem against the same problem built
    by the JAX package. h within 1e-4 m, T within 5e-3 K (the float32
    spread of jitted JAX, see test_period_coupled_fast_matches_jax),
    the heat MBR of bench.py's formula to 1e-4, the water MBR to 1e-6.

    The reference's heat semantics with advection off cool the wetting
    front: infiltrating water enters without enthalpy, so the nodes it
    wets drop far below 0 degC (printed with -s; both packages alike)."""
    n = 48
    dem = TP.synthetic_catchment(0, n=n, radius=n * 366.0 / 768)
    jp = J.SolverParameters.fast_f32(heat_vapor=True, heat_frozen_props=True)
    tp = T.SolverParameters.fast_f32(heat_vapor=True, heat_frozen_props=True)
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
                                 net_irradiance=80.0, mask=jg.mask[1])
    jwo, jho = j_period(jg, jp, jw, jh, jb, 3600.0)

    tg, tw, th, tb = TP.build_coupled_problem(dem, 4.0, tp, "cpu")
    TC.reset_counts()
    two, tho = T.compute_period_coupled(tg, tp, tw, th, tb, 3600.0)

    def heat_mbr(mod, g, p, h, w):
        st = float(mod.heat_storage(g, p, h, w))
        sink = float(h.sink_whole)
        return (st - float(h.storage_whole) - sink) / max(abs(sink), 1.0)

    mask = np.asarray(jg.mask)
    heat_mask = mask.copy()
    heat_mask[0] = False
    e_h = float(np.abs(two.h.numpy() - np.asarray(jwo.h))[mask].max())
    e_t = float(np.abs(tho.t.numpy() - np.asarray(jho.t))[heat_mask].max())
    mj, mt = heat_mbr(JH, jg, jp, jho, jwo), heat_mbr(TH, tg, tp, tho, two)
    t_port = tho.t.numpy()[heat_mask]
    print(f"coupled storm, 48 box: {TC.counts()}; max|dh| {e_h} m, max|dT| {e_t} K; "
          f"heat MBR {mt} vs {mj}; water MBR {float(two.balance_whole.mbr)} vs "
          f"{float(jwo.balance_whole.mbr)}; T {t_port.min()}..{t_port.max()} K, "
          f"share below 273.15 K {float((t_port < 273.15).mean())} (JAX "
          f"{float((np.asarray(jho.t)[heat_mask] < 273.15).mean())})")
    assert e_h <= 1e-4 and e_t <= 5e-3
    assert mt == pytest.approx(mj, abs=1e-4)
    assert float(two.balance_whole.mbr) == pytest.approx(
        float(jwo.balance_whole.mbr), abs=1e-6)


def test_heat_column_matches_jax_setup():
    """problems.heat_column builds the JAX test's column: grid fields,
    water state, heat state and forcing equal (rel 1e-13)."""
    jp, tp = J.SolverParameters(heat_vapor=True), T.SolverParameters(heat_vapor=True)
    jg, jw, jh, jb = jax_column(jp)
    tg, tw, th, tb = TP.heat_column(tp, "cpu")
    for a, b in ((jg.btype, tg.btype), (jg.bsize, tg.bsize), (jg.z, tg.z),
                 (jw.h, tw.h), (jh.t, th.t), (jb.mask, tb.mask),
                 (jb.net_irradiance, tb.net_irradiance)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-13)
    assert float(th.storage_prev) == pytest.approx(float(jh.storage_prev), rel=1e-13)

"""The port's soil-heat module against the JAX package, function by
function: material properties, the atmospheric surface boundary, the link
fluxes, one heat sub-step (float64 and float32 "fast"), the frozen chunk
system and its sub-step, the storage, and the water solver's heat-coupling
hooks (``assemble_fast`` and a float64 hour with both hooks).

Both implementations get the same seeded numpy inputs; the port runs on
the CPU and JAX op by op. Tolerances: rel 1e-12 on float64 inputs and rel
1e-5 on float32 inputs (float ulps of two libraries' exp/log/pow), with an
absolute floor of the tolerance times the field's max |value| where a
field is 0 or cancels.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import criteria3d_tpu as J
from criteria3d_tpu.solver import heat as JH
from criteria3d_tpu.solver import water as JW
import criteria3d_tpu_torch as T
from criteria3d_tpu_torch import convert
from criteria3d_tpu_torch.solver import heat as TH
from criteria3d_tpu_torch.solver import water as TW
from tests.test_catchment3d import valley_dem
from tests.test_torch_core import (build_grids, dtype_name, port_grid,
                                   port_state, rain_states, to_arrays)

torch.set_num_threads(1)

F64, F32 = 1e-12, 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def close(t, j, rtol, name=""):
    assert dtype_name(t) == dtype_name(j), name
    a = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), a, rtol=rtol,
                               atol=rtol * float(np.abs(a).max()), err_msg=name)


def seeded(seed=0, n=8, vapor=True, advection=False, fast=False):
    """valley_dem(n) (10 m cells, 0.6 m of soil), every layer-1 node a
    HeatSurface; seeded heads (unsaturated, a few saturated, ponded
    surface), temperatures 275-305 K, a second head field one sub-step on,
    k from the heads, a little sink; seeded forcing. Returns (jax params,
    port params, jax grid, port grid, jax water, port water, jax heat, port
    heat, jax boundary, port boundary)."""
    kw = dict(heat_vapor=vapor, heat_advection=advection)
    jp = J.SolverParameters.fast_f32(**kw) if fast else J.SolverParameters(**kw)
    tp = T.SolverParameters.fast_f32(**kw) if fast else T.SolverParameters(**kw)
    jg, _ = build_grids(valley_dem(n))
    bt = np.asarray(jg.btype).copy()
    bt[1][np.asarray(jg.mask[1])] = int(J.BoundaryType.HEAT_SURFACE)
    jg = dataclasses.replace(jg, btype=jnp.asarray(bt))
    tg = port_grid(jg)
    rng = np.random.default_rng(seed)
    shape, mask, z = jg.shape, np.asarray(jg.mask), np.asarray(jg.z)
    psi_old = rng.uniform(-2.5, 0.05, shape)
    psi_old[0] = rng.uniform(0.0, 0.004, shape[1:])
    psi = psi_old + rng.uniform(-0.05, 0.08, shape)
    psi[0] = np.maximum(psi[0], 0.0)
    h = np.where(mask, z + psi, 0.0)
    h_old = np.where(mask, z + psi_old, 0.0)
    js = J.WaterState.initialize(jg, jp, matric_potential=-1.0)
    se = JW.compute_se(jg, jp, jnp.asarray(h))
    _, k = JW.compute_capacity(jg, jp, jnp.asarray(h), jnp.asarray(h_old), se)
    sink = np.zeros(shape)
    sink[0] = np.where(mask[0], rng.uniform(0.0, 3e-5, shape[1:]), 0.0)
    js = dataclasses.replace(js, h=jnp.asarray(h), h_old=jnp.asarray(h_old),
                             se=se, k=k, sink_source=jnp.asarray(sink))
    t = np.where(mask, rng.uniform(275.0, 305.0, shape), 273.15)
    t_old = np.where(mask, t + rng.uniform(-0.5, 0.5, shape), 273.15)
    jh = JH.initialize_heat(jg, 283.15)
    jh = dataclasses.replace(jh, t=jnp.asarray(t), t_old=jnp.asarray(t_old))
    jh = dataclasses.replace(jh, storage_prev=JH.heat_storage(jg, jp, jh, js))
    r, c = shape[1:]
    jb = JH.HeatBoundary.uniform(
        (r, c), air_temperature=298.15, rel_humidity=55.0, wind_speed=2.5,
        net_irradiance=250.0, mask=jg.mask[1])
    jb = dataclasses.replace(
        jb, air_temperature=jnp.asarray(rng.uniform(280.0, 305.0, (r, c))),
        wind_speed=jnp.asarray(rng.uniform(0.0, 6.0, (r, c))),
        rel_humidity=jnp.asarray(rng.uniform(30.0, 95.0, (r, c))))
    th = convert.heat_state_from_arrays(to_arrays(jh), device="cpu")
    tb = convert.heat_boundary_from_arrays(to_arrays(jb), device="cpu")
    return jp, tp, jg, tg, js, port_state(js), jh, th, jb, tb


# ----------------------------------------------------------------------
# properties and the surface boundary
# ----------------------------------------------------------------------

@pytest.mark.parametrize("f32", [False, True], ids=["f64", "f32"])
def test_properties_match_jax(f32):
    """Every property function on seeded heads and temperatures, on the
    grid in float64 (rel 1e-12) and cast to float32 (rel 1e-5)."""
    jp, tp, jg, tg, js, ts, jh, th, _, _ = seeded(seed=1)
    rtol = F32 if f32 else F64
    if f32:
        jg, tg = jg.astype(jnp.float32), tg.astype(torch.float32)
    dt = jnp.float32 if f32 else jnp.float64
    psi_j = js.h.astype(dt) - jg.z
    t_j = jh.t.astype(dt)
    psi_t, t_t = _t(psi_j), _t(t_j)
    close(TH.theta_from_signed_psi(tg, tp, psi_t),
          JH.theta_from_signed_psi(jg, jp, psi_j), rtol, "theta")
    close(TH.pressure_from_altitude(tg.z), JH.pressure_from_altitude(jg.z),
          rtol, "pressure")
    close(TH.vapor_from_psi_temp(psi_t, t_t), JH.vapor_from_psi_temp(psi_j, t_j),
          rtol, "vapor")
    close(TH.soil_relative_humidity(psi_t, t_t),
          JH.soil_relative_humidity(psi_j, t_j), rtol, "rh")
    theta_j = JH.theta_from_signed_psi(jg, jp, psi_j)
    close(TH.water_return_flow_factor(_t(theta_j), t_t, TH._clay(tg)),
          JH.water_return_flow_factor(theta_j, t_j, JH._clay(jg)), rtol, "f_ret")
    close(TH.estimate_bulk_density(tg), JH.estimate_bulk_density(jg), rtol, "bulk")
    for fn in ("thermal_vapor_conductivity", "isothermal_vapor_conductivity"):
        close(getattr(TH, fn)(tg, tp, t_t, psi_t),
              getattr(JH, fn)(jg, jp, t_j, psi_j), rtol, fn)
    for vapor in (False, True):
        close(TH.soil_thermal_conductivity(tg, tp, t_t, psi_t, with_vapor=vapor),
              JH.soil_thermal_conductivity(jg, jp, t_j, psi_j, with_vapor=vapor),
              rtol, f"conductivity vapor={vapor}")
        close(TH.heat_capacity(tg, tp, psi_t, t_t, with_vapor=vapor),
              JH.heat_capacity(jg, jp, psi_j, t_j, with_vapor=vapor),
              rtol, f"capacity vapor={vapor}")
        close(TH._node_heat_energy(tg, dataclasses.replace(tp, heat_vapor=vapor),
                                   psi_t, t_t),
              JH._node_heat_energy(jg, dataclasses.replace(jp, heat_vapor=vapor),
                                   psi_j, t_j), rtol, f"energy vapor={vapor}")


def test_surface_boundary_matches_jax():
    """Aerodynamic conductance (20 Monin-Obukhov iterations, stable and
    unstable air), boundary vapor, the frozen conductances and both
    atmospheric vapor fluxes, float64: rel 1e-12."""
    jp, tp, jg, tg, js, ts, jh, th, jb, tb = seeded(seed=2)
    close(TH.aerodynamic_conductance(tb, th.t[1]),
          JH.aerodynamic_conductance(jb, jh.t[1]), F64, "aero_k")
    for a, b in zip(TH.boundary_vapor_concentration(tb),
                    JH.boundary_vapor_concentration(jb)):
        close(a, b, F64, "boundary vapor")
    cj = JH.surface_conductances(jg, jp, jh, jb, js.h)
    ct = TH.surface_conductances(tg, tp, th, tb, ts.h)
    for a, b in zip(ct, cj):
        close(a, b, F64, "conductances")
    close(TH.atmospheric_latent_vapor_flux(tg, tp, th, tb, ts),
          JH.atmospheric_latent_vapor_flux(jg, jp, jh, jb, js), F64, "vapor flux")
    close(TH.atmospheric_latent_surface_water_flux(tb, ct[0]),
          JH.atmospheric_latent_surface_water_flux(jb, cj[0]), F64, "surface flux")
    # stable and unstable air both ran
    d = np.asarray(jb.air_temperature) - np.asarray(jh.t[1])
    assert (d > 0).any() and (d < 0).any()


@pytest.mark.parametrize("advection", [False, True], ids=["plain", "advection"])
def test_update_boundary_heat_matches_jax(advection):
    """Boundary heat flow (radiative, sensible, latent, and with
    heat_advection the infiltration, vapor and drainage advection
    branches): rel 1e-12; the same Courant-limited dt_heat."""
    jp, tp, jg, tg, js, ts, jh, th, jb, tb = seeded(seed=3, advection=advection)
    dts = []
    for dt_max in (600.0, 37.5):
        fj, dj, xj = JH.update_boundary_heat(jg, jp, jh, jb, js, dt_max, 600.0)
        ft, dt_, xt = TH.update_boundary_heat(tg, tp, th, tb, ts, dt_max, 600.0)
        close(ft, fj, F64, "heat flow")
        assert dt_ == float(dj)
        dts.append(dt_)
        for key in ("sensible", "aerodynamic_conductance"):
            close(xt[key], xj[key], F64, key)
    # the Courant limit cut the long chunk
    assert dts[0] < 600.0


def test_heat_surface_water_sink_matches_jax():
    """The evaporative water sink from float32 psi (the fast path's hook
    input) and from the float64 state: float64 out, rel 1e-5 and 1e-12."""
    jp, tp, jg, tg, js, ts, jh, th, jb, tb = seeded(seed=4, fast=True)
    cj = JH.surface_conductances(jg, jp, jh, jb, js.h)
    ct = tuple(_t(a) for a in cj)
    psi32 = (js.h - jg.z).astype(jnp.float32)
    sj = JH.heat_surface_water_sink(jg, jp, jh, jb, psi32, jnp.asarray(120.0),
                                    conductances=cj)
    st = TH.heat_surface_water_sink(tg, tp, th, tb, _t(psi32), 120.0,
                                    conductances=ct)
    assert dtype_name(st) == dtype_name(sj) == "float64"
    close(st, sj, F32, "sink f32 psi")
    close(TH.heat_surface_water_sink(tg, tp, th, tb, ts, 120.0),
          JH.heat_surface_water_sink(jg, jp, jh, jb, js, jnp.asarray(120.0)),
          F64, "sink f64")
    assert np.abs(np.asarray(sj)[1]).max() > 0


# ----------------------------------------------------------------------
# link fluxes
# ----------------------------------------------------------------------

@pytest.mark.parametrize("vapor", [False, True], ids=["liquid", "vapor"])
def test_link_fluxes_match_jax(vapor):
    """thermal_water_flux (from the f64 state and from f32 psi/k),
    isothermal_latent_link_flux and advective_link_coefficients: rel 1e-12
    in float64 (1e-5 from float32 inputs)."""
    jp, tp, jg, tg, js, ts, jh, th, _, _ = seeded(seed=5, vapor=vapor)
    close(TH.thermal_water_invariant_flux(tg, tp, th, ts),
          JH.thermal_water_invariant_flux(jg, jp, jh, js), F64, "thermal flux")
    psi32, k32 = (js.h - jg.z).astype(jnp.float32), js.k.astype(jnp.float32)
    close(TH.thermal_water_flux(tg, tp, th, _t(psi32), _t(k32)),
          JH.thermal_water_flux(jg, jp, jh, psi32, k32), F32, "thermal flux f32")
    node_h = js.h + 0.01
    close(TH.isothermal_latent_link_flux(tg, tp, th, ts, _t(node_h)),
          JH.isothermal_latent_link_flux(jg, jp, jh, js, node_h), F64, "latent")
    for a, b, name in zip(TH.advective_link_coefficients(tg, tp, th, ts, _t(node_h)),
                          JH.advective_link_coefficients(jg, jp, jh, js, node_h),
                          ("adv_up", "adv_down", "adv_lat", "adv_diag", "adv_b")):
        close(a, b, F64, name)


# ----------------------------------------------------------------------
# the sub-step
# ----------------------------------------------------------------------

@pytest.mark.parametrize("fast", [False, True], ids=["f64", "fast"])
@pytest.mark.parametrize("advection", [False, True], ids=["plain", "advection"])
def test_heat_step_matches_jax(fast, advection):
    """One heat sub-step, with the chunk's frozen flow and the energy cache
    (the coupled step's call) and without either (the legacy call):
    T within 1e-9 K (float64) or 1e-4 K (float32), the same accept flag,
    the storage to rel 1e-9 and the MBR to rel 1e-9 (float64) or 1e-5
    (a float32 ulp of theta moves the float64 balance)."""
    jp, tp, jg, tg, js, ts, jh, th, jb, tb = seeded(seed=6, fast=fast,
                                                     advection=advection)
    fj, _, _ = JH.update_boundary_heat(jg, jp, jh, jb, js, 60.0, 300.0)
    ft = _t(fj)
    tol, mrel = (1e-4, F32) if fast else (1e-9, 1e-9)
    for dt in (60.0, 7.5):
        invj = JH.energy_invariants(jg, jp, js, dt, 300.0)
        invt = TH.energy_invariants(tg, tp, ts, dt, 300.0)
        for name in invj._fields:
            j = getattr(invj, name)
            if j is not None:
                close(getattr(invt, name), j,
                      F32 if j.dtype == jnp.float32 else F64, name)
        nj, mj = JH.heat_step(jg, jp, jh, jb, js, jnp.asarray(dt), jnp.asarray(300.0),
                              heat_flow=fj, energy_cache=invj)
        nt, mt = TH.heat_step(tg, tp, th, tb, ts, dt, 300.0, heat_flow=ft,
                              energy_cache=invt)
        ok_j = abs(float(mj)) <= 1.0 or dt <= 10.0
        ok_t = abs(mt) <= 1.0 or dt <= 10.0
        print(f"heat_step fast={fast} dt={dt}: mbr {mt} vs {float(mj)}")
        assert ok_t == ok_j
        np.testing.assert_allclose(nt.t.numpy(), np.asarray(nj.t), rtol=0, atol=tol)
        assert mt == pytest.approx(float(mj), rel=mrel, abs=1e-9)
        assert float(nt.storage_prev) == pytest.approx(float(nj.storage_prev), rel=1e-9)
    nj, mj = JH.heat_step(jg, jp, jh, jb, js, 60.0, 300.0)
    nt, mt = TH.heat_step(tg, tp, th, tb, ts, 60.0, 300.0)
    np.testing.assert_allclose(nt.t.numpy(), np.asarray(nj.t), rtol=0, atol=tol)
    assert mt == pytest.approx(float(mj), rel=mrel, abs=1e-9)


def test_frozen_chunk_system_matches_jax():
    """chunk_frozen_system (rel 1e-5 on its float32 factors) and three
    heat_substep_frozen sub-steps of halving length: T within 1e-4 K, the
    same ok flags, storage to rel 1e-9."""
    jp = J.SolverParameters.fast_f32(heat_vapor=True, heat_frozen_props=True,
                                     heat_advection=True)
    tp = T.SolverParameters.fast_f32(heat_vapor=True, heat_frozen_props=True,
                                     heat_advection=True)
    _, _, jg, tg, js, ts, jh, th, jb, tb = seeded(seed=7, fast=True)
    fj, chunk, _ = JH.update_boundary_heat(jg, jp, jh, jb, js, 120.0, 300.0)
    chunk = float(chunk)
    fsum = jnp.sum(jnp.where(jg.mask.at[0].set(False), fj, 0.0))
    invj = JH.energy_invariants(jg, jp, js, chunk, 300.0)
    fzj = JH.chunk_frozen_system(jg, jp, jh.t, js, chunk, 300.0, fj, fsum, invj)
    invt = TH.energy_invariants(tg, tp, ts, chunk, 300.0)
    fzt = TH.chunk_frozen_system(tg, tp, th.t, ts, chunk, 300.0, _t(fj),
                                 _t(fsum), invt)
    for name in fzj._fields:
        if name not in ("inv", "tol"):
            close(getattr(fzt, name), getattr(fzj, name), F32, name)
    assert float(fzt.tol) == float(fzj.tol)
    tj, spj, swj = jh.t, jh.storage_prev, jh.sink_whole
    tt, spt, swt = th.t, th.storage_prev, th.sink_whole
    for dt in (chunk, chunk / 2, chunk / 4):
        tj, spj, swj, mj, okj = JH.heat_substep_frozen(jg, jp, fzj, tj, spj, swj, dt)
        tt, spt, swt, mt, okt = TH.heat_substep_frozen(tg, tp, fzt, tt, spt, swt, dt)
        assert okt == bool(okj)
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0, atol=1e-4)
        assert float(spt) == pytest.approx(float(spj), rel=1e-9)
        assert float(mt) == pytest.approx(float(mj), rel=1e-6, abs=1e-6)


def test_heat_storage_matches_jax():
    for vapor in (False, True):
        jp, tp, jg, tg, js, ts, jh, th, _, _ = seeded(seed=8, vapor=vapor)
        assert float(TH.heat_storage(tg, tp, th, ts)) == pytest.approx(
            float(JH.heat_storage(jg, jp, jh, js)), rel=F64)
        cj = JH._storage_from_invariants(
            jg, jp, JH.energy_invariants(jg, jp, js, 30.0, 60.0), jh.t,
            jg.mask.at[0].set(False))
        ct = TH._storage_from_invariants(
            tg, tp, TH.energy_invariants(tg, tp, ts, 30.0, 60.0), th.t,
            TH._heat_mask(tg))
        assert float(ct) == pytest.approx(float(cj), rel=F64)


# ----------------------------------------------------------------------
# the water solver's hooks
# ----------------------------------------------------------------------

def _twin_hooks(grid_j, grid_t):
    """The same hooks for both packages: an RHS flux proportional to psi
    and k, and a boundary sink on the first soil layer bounded by dt."""
    def extra_j(psi, k):
        return jnp.where(grid_j.mask.at[0].set(False), 1e-3 * k * (psi + 0.5), 0.0)

    def bound_j(psi, dt):
        return jnp.zeros(grid_j.shape).at[1].set(
            jnp.where(grid_j.mask[1], -2e-7 * (1.0 + jnp.tanh(psi[1])) * 60.0 / dt,
                      0.0))

    def extra_t(psi, k):
        return torch.where(TH._heat_mask(grid_t), 1e-3 * k * (psi + 0.5), 0.0)

    def bound_t(psi, dt):
        out = torch.zeros(grid_t.shape, dtype=torch.float64)
        out[1] = torch.where(grid_t.mask[1],
                             -2e-7 * (1.0 + torch.tanh(psi[1])) * 60.0 / dt, 0.0)
        return out

    return (extra_j, bound_j), (extra_t, bound_t)


def test_assemble_fast_with_hooks_matches_jax():
    """assemble_fast with both hooks: the boundary hook joins the rate and
    the flows, the extra flux only the RHS; system, flows, rate and k to
    rel 1e-5, and the hooks move b against the hook-free assembly."""
    jp, tp = J.SolverParameters.fast_f32(), T.SolverParameters.fast_f32()
    jg, tg = build_grids(valley_dem(8))
    js, ts = rain_states(jg, jp, tg, tp, psi0=-1.0, rain_mm_h=20.0)
    (ej, bj), (et, bt) = _twin_hooks(jg, tg)
    psi = (js.h - jg.z).astype(jnp.float32) + 0.01
    psi = jnp.where(jg.mask, psi, 0.0)
    psi_old = jnp.where(jg.mask, (js.h - jg.z).astype(jnp.float32), 0.0)
    se = JW.compute_se_psi(jg, jp, psi)
    outj = JW.assemble_fast(jg, jp, psi, psi_old, se, js.sink_source, js.pond,
                            0, jnp.asarray(60.0), extra_flux_fn=ej,
                            boundary_flux_fn=bj)
    outt = TW.assemble_fast(tg, tp, _t(psi), _t(psi_old), _t(se), ts.sink_source,
                            ts.pond, 0, 60.0, extra_flux_fn=et,
                            boundary_flux_fn=bt)
    for name in TW.LinearSystem._fields:
        close(getattr(outt[0], name), getattr(outj[0], name), F32, name)
    for a, b, name in zip(outt[1:], outj[1:], ("water_flow", "rate", "k")):
        close(a, b, F32, name)
    plain = TW.assemble_fast(tg, tp, _t(psi), _t(psi_old), _t(se), ts.sink_source,
                             ts.pond, 0, 60.0)
    assert not torch.equal(plain[0].b, outt[0].b)
    assert not torch.equal(plain[2], outt[2])


def test_f64_hour_with_hooks_matches_jax():
    """A float64 hour of compute_step's loop with both hooks (JAX's
    _compute_step called with them, against the port's), valley_dem(8),
    20 mm/h: the same (attempts, approximations, sweeps) each step, h
    within 1e-9 m."""
    from criteria3d_tpu.solver.step import _compute_step as j_cs
    from criteria3d_tpu_torch.solver.step import _compute_step as t_cs
    jp, tp = J.SolverParameters(), T.SolverParameters()
    jg, tg = build_grids(valley_dem(8))
    js, ts = rain_states(jg, jp, tg, tp, psi0=-1.0, rain_mm_h=20.0)
    (ej, bj), (et, bt) = _twin_hooks(jg, tg)
    import jax
    jstep = jax.jit(lambda st, m: j_cs(jg, jp, st, m, extra_flux_fn=ej,
                                       boundary_flux_fn=bj))
    t = 0.0
    while t < 3600.0:
        js, jdt, jstats, jrate = jstep(js, jnp.asarray(3600.0 - t))
        ts, tdt, tstats, trate, _ = t_cs(tg, tp, ts, 3600.0 - t,
                                         extra_flux_fn=et, boundary_flux_fn=bt)
        assert tdt == float(jdt)
        assert tstats == tuple(int(s) for s in jstats)
        t += tdt
    np.testing.assert_allclose(ts.h.numpy(), np.asarray(js.h), rtol=0, atol=1e-9)
    close(trate, jrate, 1e-9, "boundary rate")

"""The port's HYDRALL forest model and RothC soil carbon model against the
JAX package: every function of physics/hydrall.py and physics/rothc.py on
tests/test_hydrall.py's and test_rothc_watertable.py's inputs and on seeded
maps, then both models inside the hourly model cycle (model.py): hours,
the daily and Jan-1 annual HYDRALL steps, the monthly RothC step and
``run_period`` across a month end and a Jan 1.

Both implementations get the same numpy inputs; the port runs on the CPU.
Tolerances: the functions rel 1e-12 (floor 1e-12 of the max), as the other
physics modules; the fixed point (``photosynthesis_kernel``) rel 1e-12 on
its outputs plus each cell's stop iteration, which must equal JAX's (a
cell whose |dASS| lies within rounding of ``tol`` could stop one iteration
apart; the test counts such flips and requires none); float64 model hours
the same ``dt_curr``, heads within 1e-9 m, HYDRALL and RothC maps rel 1e-9;
``fast_f32()`` hours heads within 1e-4 m and both |MBR| < 2e-3;
``run_period`` across Dec 31 and Jan 1: RothC pools, LAI and litter rel
1e-9. State dtypes equal JAX's after every step.
"""

import dataclasses
import datetime

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import criteria3d_tpu as J
from criteria3d_tpu.core.grid import slope_aspect
from criteria3d_tpu.model import Criteria3DModel as JModel
from criteria3d_tpu.model import HourlyForcing as JForcing
from criteria3d_tpu.model import ModelConfig as JConfig
from criteria3d_tpu.physics import hydrall as JH
from criteria3d_tpu.physics import rothc as JR
from criteria3d_tpu.physics.snow import SnowState as JSnow
import criteria3d_tpu_torch as T
from criteria3d_tpu_torch import convert, problems
from criteria3d_tpu_torch.model import Criteria3DModel as TModel
from criteria3d_tpu_torch.model import HourlyForcing as TForcing
from criteria3d_tpu_torch.model import ModelConfig as TConfig
from criteria3d_tpu_torch.physics import hydrall as TH
from criteria3d_tpu_torch.physics import rothc as TR
from criteria3d_tpu_torch.physics.snow import SnowState as TSnow
from tests.test_catchment3d import valley_dem
from tests.test_torch_core import build_grids, dtype_name, grid_meta, to_arrays
from tests.test_torch_physics import close

torch.set_num_threads(1)

F64 = 1e-12


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64, copy=True))


def midday_env():
    return dict(lai=4.0, sine_solar_elevation=0.8, direct_irradiance=600.0,
                diffuse_irradiance=150.0, air_temp_c=22.0,
                longwave_irradiance=350.0)


def seeded_env(seed=1, shape=(6, 8)):
    """Seeded (R, C) maps over the range a forest hour sees: a quarter of
    the cells at night (sun below the horizon)."""
    rng = np.random.default_rng(seed)
    sin_el = rng.uniform(0.0, 1.0, shape)
    sin_el[rng.random(shape) < 0.25] = 0.0
    return dict(lai=rng.uniform(0.5, 6.0, shape), sine_solar_elevation=sin_el,
                direct_irradiance=rng.uniform(0.0, 800.0, shape),
                diffuse_irradiance=rng.uniform(0.0, 300.0, shape),
                air_temp_c=rng.uniform(-5.0, 35.0, shape),
                longwave_irradiance=rng.uniform(250.0, 420.0, shape),
                rh=rng.uniform(20.0, 100.0, shape),
                pressure=rng.uniform(85000.0, 102000.0, shape),
                t30=rng.uniform(0.0, 25.0, shape))


RAD_KEYS = ("lai", "sine_solar_elevation", "direct_irradiance",
            "diffuse_irradiance", "air_temp_c", "longwave_irradiance")


def assert_dicts(tout, jout, rtol=F64, label=""):
    assert sorted(tout) == sorted(jout), label
    for k in jout:
        close(tout[k], jout[k], rtol, f"{label} {k}")


# ----------------------------------------------------------------------
# HYDRALL functions
# ----------------------------------------------------------------------

@pytest.mark.parametrize("case", ["midday", "night", "map"])
def test_big_leaf_radiation_and_leaf_temperature_match_jax(case):
    if case == "map":
        env = seeded_env()
        jin = {k: jnp.asarray(env[k]) for k in RAD_KEYS}
        tin = {k: _t(env[k]) for k in RAD_KEYS}
    else:
        env = dict(midday_env(), **({"sine_solar_elevation": 0.0}
                                    if case == "night" else {}))
        jin = tin = env
    assert_dicts(TH.big_leaf_radiation(**tin), JH.big_leaf_radiation(**jin),
                 label=case)
    args = ("air_temp_c", "direct_irradiance", "diffuse_irradiance")
    jt = JH.leaf_temperature(*(jin[k] for k in args), 1000.0, 66.0,
                             jin["sine_solar_elevation"])
    tt = TH.leaf_temperature(*(tin[k] for k in args), 1000.0, 66.0,
                             tin["sine_solar_elevation"])
    for a, b, name in zip(tt, jt, ("t_sun", "t_shade")):
        close(a, b, name=f"{case} {name}")


def _farquhar_inputs(case):
    """(jax kwargs, port kwargs) of farquhar_parameters: test_hydrall.py's
    sunlit big leaf at 15 and 25 degC, or the seeded maps."""
    if case == "map":
        env = seeded_env()
        jr = JH.big_leaf_radiation(**{k: jnp.asarray(env[k]) for k in RAD_KEYS})
        jt_sun, _ = JH.leaf_temperature(
            jnp.asarray(env["air_temp_c"]), jnp.asarray(env["direct_irradiance"]),
            jnp.asarray(env["diffuse_irradiance"]), 1000.0, 66.0,
            jnp.asarray(env["sine_solar_elevation"]))
        arr = dict(leaf_t_k=np.asarray(jt_sun), absorbed_par=np.asarray(jr["par_sunlit"]),
                   lai=env["lai"], kb=np.asarray(jr["kb"]), kd_par=np.asarray(jr["kd_par"]),
                   pressure_pa=env["pressure"], last30_t_avg=env["t30"])
        return ({k: jnp.asarray(v) for k, v in arr.items()},
                {k: _t(v) for k, v in arr.items()})
    rad = JH.big_leaf_radiation(**midday_env())
    common = dict(absorbed_par=float(rad["par_sunlit"]), lai=4.0,
                  kb=float(rad["kb"]), kd_par=float(rad["kd_par"]),
                  pressure_pa=101325.0, last30_t_avg=18.0)
    t_k = {"15C": 288.15, "25C": 298.15}[case]
    return (dict(common, leaf_t_k=jnp.float64(t_k)),
            dict(common, leaf_t_k=torch.tensor(t_k, dtype=torch.float64)))


@pytest.mark.parametrize("case", ["15C", "25C", "map"])
@pytest.mark.parametrize("sunlit", [True, False])
def test_farquhar_parameters_match_jax(case, sunlit):
    jin, tin = _farquhar_inputs(case)
    assert_dicts(TH.farquhar_parameters(**tin, sunlit=sunlit),
                 JH.farquhar_parameters(**jin, sunlit=sunlit), label=case)


def _kernel_inputs(case):
    """(jax params, port params, jax env, port env, stress) of the fixed
    point: test_hydrall.py's sunlit leaf (stress 1 and 0.05, and night with
    J = 0), or the seeded maps through big_leaf_radiation and
    farquhar_parameters (the hour's path)."""
    if case == "map":
        env = seeded_env()
        jin, tin = _farquhar_inputs("map")
        jp = JH.farquhar_parameters(**jin)
        t_c = env["air_temp_c"]
        es = 611.0 * np.exp(17.502 * t_c / (t_c + 240.97))
        vpd = np.maximum(es * (1.0 - env["rh"] / 100.0), 0.0)
        slope = 4098.0 * (es / 1000.0) / ((237.3 + t_c) ** 2) * 1000.0
        psychro = 1013.0 * env["pressure"] / 1000.0 \
            / (0.622 * (2501000.0 - 2369.2 * t_c)) * 1000.0
        jr = JH.big_leaf_radiation(**{k: jnp.asarray(env[k]) for k in RAD_KEYS})
        arr = dict(co2_pa=413e-6 * env["pressure"], vpd_pa=vpd,
                   pressure_pa=env["pressure"], air_temp_c=t_c,
                   rni=np.asarray(jr["rni_sunlit"]), slope_sat_vp=slope,
                   psychro_pa=psychro)
        jenv = {k: jnp.asarray(v) for k, v in arr.items()}
        tenv = {k: _t(v) for k, v in arr.items()}
        stress = 1.0
    else:
        jin, tin = _farquhar_inputs("25C")
        jp = JH.farquhar_parameters(**jin)
        rad = JH.big_leaf_radiation(**midday_env())
        jenv = tenv = dict(co2_pa=40.0, vpd_pa=1000.0, pressure_pa=101325.0,
                           air_temp_c=25.0, rni=float(rad["rni_sunlit"]),
                           slope_sat_vp=145.0, psychro_pa=66.0)
        stress = 0.05 if case == "stressed" else 1.0
        if case == "night":
            jp = dict(jp, j=jnp.zeros_like(jp["j"]))
    tp = {k: _t(np.asarray(v)) for k, v in jp.items()}
    return jp, tp, jenv, tenv, stress


def stop_flips(run_jax, stop, d_ass, final) -> int:
    """Cells whose stop iteration differs between the packages.

    ``run_jax(m)`` runs the JAX fixed point with ``max_iter=m``;
    ``stop``, ``d_ass``: the port's per-cell stop iteration and the |dASS|
    that stopped it; ``final``: JAX's converged outputs. A cell that stops
    at iteration s has JAX's final outputs after s + 1 loop iterations and
    not yet after s (unless its last change is at rounding level)."""
    stop = stop.numpy().reshape(-1)
    d_ass = d_ass.numpy().reshape(-1)
    fin = np.stack([np.broadcast_to(np.asarray(a), np.shape(final[0])).reshape(-1)
                    for a in final])
    scale = np.maximum(np.abs(fin), 1e-300)
    flips = 0
    for s in sorted(set(stop.tolist()) - {-1}):
        cells = stop == s
        after = np.stack([np.asarray(a).reshape(-1) for a in run_jax(s + 1)])
        before = np.stack([np.asarray(a).reshape(-1) for a in run_jax(s)])
        done_by_s = (np.abs(after - fin) <= 1e-12 * scale).all(0)
        moved_at_s = (np.abs(before - fin) > 1e-12 * scale).any(0) \
            | (d_ass <= 1e-12 * np.abs(fin[0]))
        flips += int((cells & ~(done_by_s & moved_at_s)).sum())
    return flips


@pytest.mark.parametrize("case", ["midday", "stressed", "night", "map"])
def test_photosynthesis_kernel_matches_jax(case):
    """Outputs rel 1e-12 and the same per-cell stop iteration as JAX's
    while_loop (test_hydrall.py's midday leaf stops at iteration 1, the
    loop's second pass)."""
    jp, tp, jenv, tenv, stress = _kernel_inputs(case)
    jout = JH.photosynthesis_kernel(jp, stress=stress, **jenv)
    TH.photosynthesis_kernel.iterations = 0
    *tout, info = TH.photosynthesis_kernel(tp, stress=stress, return_stop=True,
                                           **tenv)
    for a, b, name in zip(tout, jout, ("ass", "gsc", "tr")):
        close(a, b, name=f"{case} {name}")
    assert TH.photosynthesis_kernel.iterations == info["iterations"]
    if case == "midday":
        assert int(info["stop"]) == 1 and info["iterations"] == 2
    if case == "night":
        return
    flips = stop_flips(
        lambda m: JH.photosynthesis_kernel(jp, stress=stress, max_iter=m, **jenv),
        info["stop"], info["d_ass"], jout)
    print(f"{case}: stop iterations {sorted(set(info['stop'].reshape(-1).tolist()))}, "
          f"loop iterations {info['iterations']}, flipped cells {flips}")
    assert flips == 0, f"{flips} cells stop at another iteration than JAX's"


@pytest.mark.parametrize("max_iter", [63, 10000])
def test_fixed_point_machine_matches_jax(max_iter):
    """The fixed point as a machine (physics/fixed_point.py) under the eager
    driver, the CPU's, on the midday leaf with a 2 x 2 map of stress 1 and
    0.05 (their cells stop at iterations 1 and 125): at max_iter 63 (15 units of CHECK_EVERY iterations and one of
    the last 3) the stressed cells run to max_iter, as in JAX; at 10,000
    every cell stops. Each stopped cell's stop iteration is JAX's (0 flips),
    the outputs rel 1e-12 against JAX cut at the same max_iter, the loop's
    iteration count JAX's; one host read a unit."""
    import math
    from criteria3d_tpu_torch.solver import device_loop
    jp, tp, jenv, tenv, _ = _kernel_inputs("stressed")
    stress = np.array([[1.0, 0.05], [0.05, 1.0]])
    jout = JH.photosynthesis_kernel(jp, stress=jnp.asarray(stress), max_iter=max_iter, **jenv)
    device_loop.reset_counts()
    *tout, info = TH.photosynthesis_kernel(tp, stress=_t(stress), max_iter=max_iter,
                                           return_stop=True, **tenv)
    counts = device_loop.counts()
    for a, b, name in zip(tout, jout, ("ass", "gsc", "tr")):
        close(a, b, name=f"max_iter {max_iter} {name}")
    stop = info["stop"]
    running = int((stop < 0).sum())
    assert (running > 0) == (max_iter == 63) and int((stop >= 0).sum()) > 0
    if running:
        assert info["iterations"] == max_iter
    assert counts["eager_fixed_points"] == 1
    assert counts["eager_reads"] == math.ceil(info["iterations"] / TH.CHECK_EVERY)
    flips = stop_flips(
        lambda m: JH.photosynthesis_kernel(jp, stress=jnp.asarray(stress), max_iter=m,
                                           **jenv),
        stop, info["d_ass"], jout)
    print(f"max_iter {max_iter}: stop iterations {sorted(set(stop.reshape(-1).tolist()))}, "
          f"{running} cells at max_iter, loop iterations {info['iterations']}, "
          f"flipped cells {flips}")
    assert flips == 0, f"{flips} cells stop at another iteration than JAX's"


def test_respiration_and_annual_growth_match_jax():
    """test_hydrall.py's pools (the defaults and a doubled stand) at 2 and
    15 degC, and the allocation of a 0.5 kg C m-2 NPP under three climates,
    plus seeded maps."""
    for kw in ({}, dict(foliage=0.4, sapwood=12.0, root=0.8)):
        js = JH.HydrallPlantState.initialize(**kw)
        ts = TH.HydrallPlantState.initialize(device="cpu", **kw)
        for t in (2.0, 15.0):
            close(TH.plant_respiration(ts, t, 1.0), JH.plant_respiration(js, t, 1.0),
                  name=f"respiration {kw} {t}")
    js = dataclasses.replace(JH.HydrallPlantState.initialize(),
                             npp_year=jnp.asarray(0.5))
    ts = dataclasses.replace(TH.HydrallPlantState.initialize(device="cpu"),
                             npp_year=torch.tensor(0.5, dtype=torch.float64))
    for prec, et0 in ((800.0, 900.0), (300.0, 1000.0), (1000.0, 800.0)):
        (jn, jl), (tn, tl) = (JH.annual_growth(js, yearly_prec=prec, yearly_et0=et0),
                              TH.annual_growth(ts, yearly_prec=prec, yearly_et0=et0))
        close(tl, jl, name="litter")
        for f in dataclasses.fields(jn):
            close(getattr(tn, f.name), getattr(jn, f.name), name=f.name)
    rng = np.random.default_rng(3)
    arr = {f.name: rng.uniform(0.01, 8.0, (5, 7))
           for f in dataclasses.fields(JH.HydrallPlantState)}
    js = JH.HydrallPlantState(**{k: jnp.asarray(v) for k, v in arr.items()})
    ts = TH.HydrallPlantState(**{k: _t(v) for k, v in arr.items()})
    t = rng.uniform(-10.0, 35.0, (5, 7))
    m = rng.uniform(0.0, 1.2, (5, 7))
    close(TH.plant_respiration(ts, _t(t), _t(m)),
          JH.plant_respiration(js, jnp.asarray(t), jnp.asarray(m)), name="map")
    p, e = rng.uniform(0.0, 1500.0, (5, 7)), rng.uniform(0.0, 1200.0, (5, 7))
    (jn, jl), (tn, tl) = (JH.annual_growth(js, yearly_prec=jnp.asarray(p),
                                           yearly_et0=jnp.asarray(e)),
                          TH.annual_growth(ts, yearly_prec=_t(p), yearly_et0=_t(e)))
    close(tl, jl, name="litter map")
    for f in dataclasses.fields(jn):
        close(getattr(tn, f.name), getattr(jn, f.name), name=f.name)


def _hydrall_maps(seed, shape):
    rng = np.random.default_rng(seed)
    plant = {f.name: rng.uniform(0.05, 7.0, shape)
             for f in dataclasses.fields(JH.HydrallPlantState)}
    plant["npp_year"] = rng.uniform(-0.1, 0.6, shape)
    rest = dict(lai=rng.uniform(0.5, 7.0, shape), t30_avg=rng.uniform(0.0, 25.0, shape),
                transpiration_year=rng.uniform(0.0, 300.0, shape),
                prec_year=rng.uniform(300.0, 1500.0, shape),
                et0_year=rng.uniform(300.0, 1200.0, shape))
    jm = JH.HydrallMaps(plant=JH.HydrallPlantState(
        **{k: jnp.asarray(v) for k, v in plant.items()}),
        **{k: jnp.asarray(v) for k, v in rest.items()})
    tm = convert.hydrall_maps_from_arrays(to_arrays(jm), device="cpu")
    return jm, tm


def assert_maps(tm, jm, rtol, label):
    """Every map of two dataclasses (nested included): dtype and values."""
    for f in dataclasses.fields(jm):
        a, b = getattr(jm, f.name), getattr(tm, f.name)
        if dataclasses.is_dataclass(a):
            assert_maps(b, a, rtol, f"{label}.{f.name}")
        else:
            close(b, a, rtol, f"{label}.{f.name}")


def test_hydrall_hour_daily_and_annual_steps_match_jax():
    """hydrall_hour on seeded (R, C) maps with a forest mask (NPP and
    transpiration gated, the rest over the whole map), then the daily
    running mean and the Jan-1 annual step; the CO2 scenario equal."""
    shape = (6, 8)
    jm, tm = _hydrall_maps(5, shape)
    env = seeded_env(7, shape)
    rng = np.random.default_rng(8)
    extra = dict(sun_elevation_deg=np.degrees(np.arcsin(env["sine_solar_elevation"])),
                 prec_mm=rng.uniform(0.0, 3.0, shape), et0_mm=rng.uniform(0.0, 0.6, shape))
    fmask = rng.random(shape) < 0.6
    kw = dict(air_temp_c="air_temp_c", rel_humidity="rh", beam_irr="direct_irradiance",
              diffuse_irr="diffuse_irradiance", longwave_irr="longwave_irradiance",
              pressure_pa="pressure")
    jin = {k: jnp.asarray(env[v]) for k, v in kw.items()}
    tin = {k: _t(env[v]) for k, v in kw.items()}
    jin.update({k: jnp.asarray(v) for k, v in extra.items()})
    tin.update({k: _t(v) for k, v in extra.items()})
    for year, doy in ((2023, 172), (1995, 1)):
        assert TH.atmospheric_co2_ppm(year, doy) == JH.atmospheric_co2_ppm(year, doy)
    jm2, jo = JH.hydrall_hour(jm, year=2023, doy=172, forest_mask=jnp.asarray(fmask),
                              soil_stress=0.7, **jin)
    tm2, to = TH.hydrall_hour(tm, year=2023, doy=172, forest_mask=torch.from_numpy(fmask),
                              soil_stress=0.7, **tin)
    assert_dicts(to, jo, label="hour")
    assert float(to["transpiration_mm"][~torch.from_numpy(fmask)].abs().max()) == 0.0
    assert_maps(tm2, jm2, F64, "hour")
    t_day = rng.uniform(-5.0, 30.0, shape)
    jm3 = JH.hydrall_daily_update(jm2, jnp.asarray(t_day))
    tm3 = TH.hydrall_daily_update(tm2, _t(t_day))
    assert_maps(tm3, jm3, F64, "daily")
    (jm4, jl), (tm4, tl) = JH.hydrall_annual_update(jm3), TH.hydrall_annual_update(tm3)
    close(tl, jl, name="litter")
    assert_maps(tm4, jm4, F64, "annual")


# ----------------------------------------------------------------------
# RothC
# ----------------------------------------------------------------------

def test_rothc_rate_modifiers_match_jax():
    rng = np.random.default_rng(11)
    t = np.concatenate([[-10.0, -5.0, 9.25, 25.0], rng.uniform(-15.0, 35.0, 60)])
    close(TR.rmf_temperature(_t(t)), JR.rmf_temperature(jnp.asarray(t)),
          name="rmf_temperature")
    pc = np.concatenate([[0.0, 1.0, 0.6], rng.uniform(-0.5, 1.5, 30)])
    close(TR.rmf_plant_cover(_t(pc)), JR.rmf_plant_cover(jnp.asarray(pc)),
          name="rmf_plant_cover")
    swc = rng.uniform(-80.0, 0.0, 40)
    bic = rng.uniform(-60.0, 60.0, 40)
    cover = rng.uniform(0.0, 1.0, 40) > 0.5
    for clay, depth in ((25.0, 23.0), (40.0, 30.0)):
        j = JR.rmf_moisture(jnp.asarray(swc), jnp.asarray(bic), clay, depth,
                            jnp.asarray(cover))
        t_ = TR.rmf_moisture(_t(swc), _t(bic), clay, depth, torch.from_numpy(cover))
        for a, b, name in zip(t_, j, ("swc", "rm")):
            close(a, b, name=f"rmf_moisture {clay} {name}")


def test_rothc_monthly_steps_match_jax():
    """test_rothc_watertable.py's years (warm and dry, without and with a
    carbon input; one cold month), then a year of seeded monthly maps of
    temperature, water balance, plant cover and carbon input."""
    shape = (4, 4)
    for carbon in (0.0, 1.0):
        js = JR.RothCState.initialize(shape, soc_total=60.0)
        ts = TR.RothCState.initialize(shape, soc_total=60.0, device="cpu")
        for _ in range(12):
            js, jd = JR.rothc_monthly_step(js, temp_c=18.0, monthly_bic=-20.0,
                                           clay_pct=25.0, carbon_input=carbon)
            ts, td = TR.rothc_monthly_step(ts, temp_c=18.0, monthly_bic=-20.0,
                                           clay_pct=25.0, carbon_input=carbon)
            assert_maps(ts, js, F64, f"carbon {carbon}")
            assert_dicts(td, jd, label=f"carbon {carbon}")
    js, jd = JR.rothc_monthly_step(JR.RothCState.initialize(shape), temp_c=-10.0,
                                   monthly_bic=0.0, clay_pct=25.0)
    ts, td = TR.rothc_monthly_step(TR.RothCState.initialize(shape, device="cpu"),
                                   temp_c=-10.0, monthly_bic=0.0, clay_pct=25.0)
    assert_maps(ts, js, F64, "cold")
    assert float(td["co2"].abs().max()) == 0.0
    rng = np.random.default_rng(12)
    js = JR.RothCState.initialize((5, 6), soc_total=45.0)
    ts = TR.RothCState.initialize((5, 6), soc_total=45.0, device="cpu")
    for month in range(12):
        arr = dict(temp_c=rng.uniform(-8.0, 28.0, (5, 6)),
                   monthly_bic=rng.uniform(-90.0, 80.0, (5, 6)),
                   plant_cover=rng.uniform(0.0, 1.0, (5, 6)),
                   carbon_input=rng.uniform(0.0, 0.4, (5, 6)))
        js, jd = JR.rothc_monthly_step(js, clay_pct=32.0, fym_input=0.1,
                                       **{k: jnp.asarray(v) for k, v in arr.items()})
        ts, td = TR.rothc_monthly_step(ts, clay_pct=32.0, fym_input=0.1,
                                       **{k: _t(v) for k, v in arr.items()})
        assert_maps(ts, js, F64, f"map month {month}")
        assert_dicts(td, jd, label=f"map month {month}")


# ----------------------------------------------------------------------
# the model cycle with HYDRALL and RothC
# ----------------------------------------------------------------------

CONFIG = dict(problems.HYDRALL_CONFIG)
PSI0 = -2.0
HYDRALL_OUT = ("hydrall_assimilation", "hydrall_transpiration", "et0",
               "global_radiation", "evaporation", "transpiration")


def hydrall_models(jp, tp, n=10):
    """The same model in both packages on valley_dem(n): every ported
    process, HYDRALL and RothC, slope and aspect from the DEM, the snow
    ground at -2 degC, and problems.forest_mask of seed 0 as the forest."""
    dem = valley_dem(n)
    jg, tg = build_grids(dem)
    jm = JModel.create(jg, jp, JConfig(**CONFIG), matric_potential=PSI0)
    tm = TModel.create(tg, tp, TConfig(**CONFIG), matric_potential=PSI0)
    slope, aspect = slope_aspect(dem, 10.0)
    jm.slope_deg, jm.aspect_deg = jnp.asarray(slope), jnp.asarray(aspect)
    tm.slope_deg, tm.aspect_deg = torch.tensor(slope), torch.tensor(aspect)
    jm.snow = JSnow.zero(dem.shape, surface_temp=-2.0)
    tm.snow = TSnow.zero(dem.shape, surface_temp=-2.0, device="cpu")
    fm = problems.forest_mask(dem, 0)
    assert 0 < fm.sum() < fm.size
    jm.forest_mask, tm.forest_mask = jnp.asarray(fm), torch.from_numpy(fm)
    return jm, tm


def forcing(tgrid, date, hour):
    """problems.model_day_forcing for both packages."""
    f = problems.model_day_forcing(tgrid, date, hour)
    arr = {k.name: getattr(f, k.name).numpy() for k in dataclasses.fields(f)}
    return JForcing(**{k: jnp.asarray(v) for k, v in arr.items()}), TForcing(**arr)


def assert_side_models(jm, tm, rtol, label):
    assert_maps(tm.hydrall, jm.hydrall, rtol, f"{label} hydrall")
    assert_maps(tm.rothc, jm.rothc, rtol, f"{label} rothc")


def test_create_carries_side_models():
    jm, tm = hydrall_models(J.SolverParameters(), T.SolverParameters())
    assert_side_models(jm, tm, 0.0, "create")
    assert tm._rothc_litter == 0.0 and not isinstance(tm._rothc_litter, torch.Tensor)


def test_model_hours_f64_match_jax():
    """Hours 10-11 of problems.model_day_forcing (daylight, dry) under
    SolverParameters(): the same dt_curr, heads within 1e-9 m, the HYDRALL
    outputs and maps and every output map rel 1e-9; then the daily update
    on Jan 1 (the annual step and its litter) and the monthly RothC step
    fed by the litter; state dtypes equal."""
    jm, tm = hydrall_models(J.SolverParameters(), T.SolverParameters())
    date = datetime.date(2024, 1, 1)
    for hour in (10, 11):
        jf, tf = forcing(tm.grid, date, hour)
        jo = jm.run_hour(jf, date.year, date.month, date.day, hour)
        to = tm.run_hour(tf, date.year, date.month, date.day, hour)
        assert float(tm.water.dt_curr) == float(jm.water.dt_curr), hour
        dh = float(np.abs(np.asarray(jm.water.h) - tm.water.h.numpy()).max())
        print(f"hour {hour}: max |dh| {dh} m")
        assert dh < 1e-9, hour
        for k in HYDRALL_OUT:
            close(to[k], jo[k], 1e-9, f"hour {hour} {k}")
        assert_side_models(jm, tm, 1e-9, f"hour {hour}")
    t_min, t_max = np.full((10, 10), -3.0), np.full((10, 10), 8.5)
    jm.daily_update(jnp.asarray(t_min), jnp.asarray(t_max), date=date)
    tm.daily_update(_t(t_min), _t(t_max), date=date)
    assert_side_models(jm, tm, 1e-9, "Jan 1")
    close(tm._rothc_litter, jm._rothc_litter, 1e-9, "litter")
    close(tm.lai, jm.lai, 1e-12, "crop lai")
    jd = jm.monthly_rothc_update(jnp.float64(4.0), jnp.float64(60.0), jnp.float64(25.0))
    td = tm.monthly_rothc_update(torch.tensor(4.0, dtype=torch.float64),
                                 torch.tensor(60.0, dtype=torch.float64),
                                 torch.tensor(25.0, dtype=torch.float64))
    assert_dicts(td, jd, 1e-9, "monthly")
    assert_side_models(jm, tm, 1e-9, "monthly")


def test_model_hour_fast_f32_matches_jax():
    """Hour 11 under fast_f32(): heads within 1e-4 m (float32 psi), both
    |MBR| < 2e-3, the HYDRALL outputs rel 1e-9 (float64 maps from the
    same forcing and radiation)."""
    jm, tm = hydrall_models(J.SolverParameters.fast_f32(), T.SolverParameters.fast_f32())
    date = datetime.date(2023, 6, 1)
    jf, tf = forcing(tm.grid, date, 11)
    jo = jm.run_hour(jf, 2023, 6, 1, 11)
    to = tm.run_hour(tf, 2023, 6, 1, 11)
    dh = float(np.abs(np.asarray(jm.water.h) - tm.water.h.numpy()).max())
    assert dh < 1e-4
    assert abs(float(to["mbr"])) < 2e-3 and abs(float(jo["mbr"])) < 2e-3
    for k in ("hydrall_assimilation", "hydrall_transpiration"):
        close(to[k], jo[k], 1e-9, k)
    assert_side_models(jm, tm, 1e-9, "fast")


def dry_forcing(tgrid, date, hour):
    """A dry, mild winter hour for both packages (1 water step an hour)."""
    f = problems.model_day_forcing(tgrid, date, hour)
    t = f.air_temperature.numpy() + 4.0
    shape = t.shape
    arr = dict(air_temperature=t, precipitation=np.zeros(shape),
               rel_humidity=np.full(shape, 70.0), wind_speed=np.full(shape, 2.0),
               transmissivity=np.full(shape, 0.6))
    return JForcing(**{k: jnp.asarray(v) for k, v in arr.items()}), TForcing(**arr)


def test_run_period_month_end_and_jan1_match_jax():
    """run_period over Dec 31 and Jan 1 on a 6 x 6 valley (f64): the month
    accumulator and the month-end RothC step on Dec 31, the Jan-1 annual
    HYDRALL step and its litter; RothC pools, LAI and litter rel 1e-9,
    daily MBRs within 1e-9; the port reads no host value per hour for the
    accumulator (one read per day: the daily MBR at the end)."""
    jm, tm = hydrall_models(J.SolverParameters(), T.SolverParameters(), n=6)
    first = datetime.date(2023, 12, 31)
    jlog = jm.run_period(first, 2, lambda d, h: dry_forcing(tm.grid, d, h)[0])
    tlog = tm.run_period(first, 2, lambda d, h: dry_forcing(tm.grid, d, h)[1])
    for a, b in zip(tlog, jlog):
        assert a["date"] == b["date"] and abs(a["mbr"] - b["mbr"]) < 1e-9
    assert_side_models(jm, tm, 1e-9, "period")
    close(tm._rothc_litter, jm._rothc_litter, 1e-9, "litter")
    close(tm.lai, jm.lai, 1e-9, "crop lai")
    assert isinstance(tm._rothc_litter, torch.Tensor)
    for f in dataclasses.fields(jm.rothc):
        assert dtype_name(getattr(tm.rothc, f.name)) == \
            np.asarray(getattr(jm.rothc, f.name)).dtype.name


def test_model_from_arrays_carries_side_models():
    """A JAX model after its Jan-1 annual step, carried across by
    convert.model_from_arrays with its HYDRALL maps, RothC pools and
    litter map: the carried fields equal, then one more hour in both."""
    jm, _ = hydrall_models(J.SolverParameters(), T.SolverParameters(), n=6)
    _, tg = build_grids(valley_dem(6))
    date = datetime.date(2024, 1, 1)
    jm.run_hour(dry_forcing(tg, date, 10)[0], 2024, 1, 1, 10)
    jm.daily_update(jnp.full((6, 6), -1.0), jnp.full((6, 6), 7.0), date=date)
    arrays = dict(grid=to_arrays(jm.grid), water=to_arrays(jm.water), heat=None,
                  snow=to_arrays(jm.snow), config=dataclasses.asdict(jm.config),
                  crop=dataclasses.asdict(jm.crop), hydrall=to_arrays(jm.hydrall),
                  rothc=to_arrays(jm.rothc), _rothc_litter=np.asarray(jm._rothc_litter))
    for name in convert.MODEL_MAPS:
        v = getattr(jm, name)
        arrays[name] = None if v is None else np.asarray(v)
    for name in convert.MODEL_ACCUMULATORS:
        arrays[name] = np.asarray(getattr(jm, name))
    tm = convert.model_from_arrays(arrays, grid_meta(jm.grid), T.SolverParameters(),
                                   device="cpu")
    assert_side_models(jm, tm, 0.0, "carried")
    close(tm._rothc_litter, jm._rothc_litter, 0.0, "litter")
    assert torch.equal(tm.forest_mask, torch.from_numpy(np.array(jm.forest_mask)))
    jf, tf = dry_forcing(tm.grid, date, 11)
    jm.run_hour(jf, 2024, 1, 1, 11)
    tm.run_hour(tf, 2024, 1, 1, 11)
    assert_side_models(jm, tm, 1e-9, "after")

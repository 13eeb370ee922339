"""The port's VINE3D physics against the JAX package: grapevine phenology,
growth and roots (physics/grapevine.py), the vine photosynthesis stack
(physics/vine_photosynthesis.py) and the two mildew models
(physics/downy_mildew.py, powdery_mildew.py), on tests/test_grapevine.py's
season, tests/test_downy_mildew.py's weather and seeded maps.

Both implementations get the same numpy inputs; the port runs on the CPU.
Tolerances: the float64 functions rel 1e-12 (floor 1e-12 of the max);
stages equal where they are codes; the vine fixed point rel 1e-12 on its
outputs plus each cell's stop iteration, which must equal JAX's (the test
counts cells that stop one iteration apart, at a |dASS| within rounding of
``tol``, and requires none). The mildew steps run in float32, and each
step starts from JAX's state: values within 4 float32 ulp (XLA:CPU's
float32 exp differs from torch's by an ulp in ~9% of elements); downy
mildew's mature oospores (and the cohorts and infection rates made of
them) are differences of two dormancy-breaking values
p = exp(-15.891 exp(-0.653 (htt + 1))), whose outer exponent |ln p|
multiplies an ulp of the inner exp, so they are held to 4 ulp of
p (1 + |ln p|); powdery mildew's pools are differences of ready fractions
near 1 (the whole ascospore pool), so they and the fractions made of them
are held to 4 ulp of 1;
stages, slot occupancy and infection flags equal, and every state field
keeps JAX's dtype (float32, int32, bool; powdery mildew's pools become
float64 when the forcing is float64, as in JAX).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from criteria3d_tpu.physics import downy_mildew as JD
from criteria3d_tpu.physics import grapevine as JG
from criteria3d_tpu.physics import powdery_mildew as JPM
from criteria3d_tpu.physics import vine_photosynthesis as JV
from criteria3d_tpu_torch import convert
from criteria3d_tpu_torch.physics import downy_mildew as TD
from criteria3d_tpu_torch.physics import grapevine as TG
from criteria3d_tpu_torch.physics import powdery_mildew as TPM
from criteria3d_tpu_torch.physics import vine_photosynthesis as TV
from tests.test_torch_core import dtype_name, to_arrays
from tests.test_torch_hydrall_rothc import assert_dicts, assert_maps, stop_flips
from tests.test_torch_physics import close

torch.set_num_threads(1)

F64 = 1e-12
ULP32 = 4


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64, copy=True))


def synthetic_temperature(doy):
    """tests/test_grapevine.py's Po-valley annual cycle [degC]."""
    return 13.0 + 11.0 * np.sin((doy - 105) / 365.0 * 2 * np.pi)


# ----------------------------------------------------------------------
# grapevine
# ----------------------------------------------------------------------

@pytest.mark.parametrize("case", ["point", "map"])
def test_grapevine_season_matches_jax(case):
    """tests/test_grapevine.py's season from 1 September (360 days of
    thermal sum, phenology, LAI, fruit biomass; the point run), and the
    same season on a 3 x 4 map whose cells run 0-3 K warmer with a seeded
    stress coefficient and assimilation. Each day's step starts from JAX's
    state, and every field must match rel 1e-12 (stages at their codes)."""
    jp, tp = JG.GrapevineParameters(), TG.GrapevineParameters()
    assert dataclasses.asdict(jp) == dataclasses.asdict(tp)
    shape = () if case == "point" else (3, 4)
    rng = np.random.default_rng(2)
    offset = np.zeros(shape) if case == "point" else rng.uniform(0.0, 3.0, shape)
    js = JG.GrapevineState.initialize(shape)
    stages = []
    for i in range(360):
        doy = (244 + i - 1) % 365 + 1
        t = synthetic_temperature(doy) + offset
        jt, tt = (float(t), float(t)) if case == "point" else (jnp.asarray(t), _t(t))
        after_march = 60 <= doy
        stress = 1.0 if case == "point" else rng.uniform(0.3, 1.0, shape)
        net = 2.0 if case == "point" else rng.uniform(-1.0, 4.0, shape)
        js_in = js
        ts = convert.grapevine_state_from_arrays(to_arrays(js_in), device="cpu")
        js = JG.update_thermal_sum(js, jt, after_march)
        ts = TG.update_thermal_sum(ts, tt, after_march)
        assert_maps(ts, js, F64, f"thermal sum day {i}")
        js = JG.phenology_daily_step(js, jp, jt, doy)
        ts = TG.phenology_daily_step(ts, tp, tt, doy)
        assert_maps(ts, js, F64, f"phenology day {i}")
        js = JG.lai_vine_daily(js, jp, jt, doy, stress_coefficient=(
            stress if case == "point" else jnp.asarray(stress)))
        ts = TG.lai_vine_daily(ts, tp, tt, doy, stress_coefficient=(
            stress if case == "point" else _t(stress)))
        assert_maps(ts, js, F64, f"lai day {i}")
        js = JG.fruit_biomass_step(js, jp, net if case == "point" else jnp.asarray(net))
        ts = TG.fruit_biomass_step(ts, tp, net if case == "point" else _t(net))
        assert_maps(ts, js, F64, f"fruit day {i}")
        close(TG.tartaric_acid(ts), JG.tartaric_acid(js), name=f"tartaric {i}")
        stages.append(float(np.max(np.asarray(js.stage))))
    # the season went through bud burst to veraison and the 15 Nov reset
    assert max(stages) >= JG.Stage.VERAISON and min(stages) < 1.0


def test_training_roots_and_stress_match_jax():
    """The training-system geometry, both root profiles (several layer
    counts, with and without coarse fragments), the uptake fractions and
    the saw-tooth stress: roots bit-equal (the same numpy), the tensor
    functions rel 1e-12."""
    ts = TG.TrainingSystem(shoots_per_plant=9.1, row_distance=2.5,
                           plant_distance=0.9)
    js = JG.TrainingSystem(shoots_per_plant=9.1, row_distance=2.5,
                           plant_distance=0.9)
    assert (ts.plant_density, ts.shaded_surface) == (js.plant_density, js.shaded_surface)
    for L, nr in ((8, 6), (12, 10), (4, 1)):
        np.testing.assert_array_equal(TG.vine_root_density(L, nr, 1),
                                      JG.vine_root_density(L, nr, 1))
    depth = np.array([0.0, 0.02, 0.06, 0.12, 0.2, 0.3, 0.45])
    thick = np.array([0.0, 0.04, 0.04, 0.08, 0.08, 0.12, 0.18])
    for coarse in (0.0, np.linspace(0.0, 0.3, 7)):
        np.testing.assert_array_equal(
            TG.trapezoid_root_density(depth, thick, 0.02, 0.3, coarse),
            JG.trapezoid_root_density(depth, thick, 0.02, 0.3, coarse))
    rng = np.random.default_rng(4)
    roots = JG.vine_root_density(8, 6, 1)
    ftsw = rng.uniform(0.0, 1.0, (8, 3, 5))
    ftsw[2:4] = 0.0
    for thr in (0.4, 0.25):
        close(TG.saw_stress(_t(ftsw), thr), JG.saw_stress(jnp.asarray(ftsw), thr),
              name=f"saw {thr}")
    saw = np.asarray(JG.saw_stress(jnp.asarray(ftsw)))
    close(TG.layer_uptake_fractions(_t(roots)[:, None, None], _t(saw)),
          JG.layer_uptake_fractions(jnp.asarray(roots)[:, None, None], jnp.asarray(saw)),
          name="uptake fractions")


def test_layer_uptake_fractions_by_keyword():
    """``layer_uptake_fractions`` called with its arguments by name, as
    JAX names them (root_density, saw_stress): the positional call's
    values, and JAX's keyword call's."""
    rng = np.random.default_rng(5)
    roots = JG.vine_root_density(8, 6, 1)[:, None, None]
    saw = np.asarray(JG.saw_stress(jnp.asarray(rng.uniform(0.0, 1.0, (8, 3, 5)))))
    t = TG.layer_uptake_fractions(root_density=_t(roots), saw_stress=_t(saw))
    assert torch.equal(t, TG.layer_uptake_fractions(_t(roots), _t(saw)))
    close(t, JG.layer_uptake_fractions(root_density=jnp.asarray(roots),
                                       saw_stress=jnp.asarray(saw)),
          name="uptake fractions by keyword")


# ----------------------------------------------------------------------
# vine photosynthesis
# ----------------------------------------------------------------------

def canopy_env(seed=9, shape=(4, 6), n_layers=6):
    """Seeded (R, C) weather and canopy maps and an (L, R, C) saw-stress
    profile with dry layers: a quarter of the cells at night."""
    rng = np.random.default_rng(seed)
    elev = rng.uniform(2.0, 70.0, shape)
    elev[rng.random(shape) < 0.25] = -5.0
    stress = rng.uniform(0.0, 1.0, (n_layers,) + shape)
    stress[0] = 0.0
    stress[stress < 0.2] = 0.0
    roots = JG.vine_root_density(n_layers, n_layers - 2, 1)[:, None, None]
    return dict(lai=rng.uniform(0.2, 4.5, shape), sun_elevation_deg=elev,
                direct_irr=rng.uniform(0.0, 800.0, shape),
                diffuse_irr=rng.uniform(10.0, 250.0, shape),
                cloudiness=rng.uniform(0.0, 0.9, shape),
                t_air_c=rng.uniform(8.0, 34.0, shape),
                rh_pct=rng.uniform(25.0, 99.0, shape),
                wind_speed=rng.uniform(0.2, 7.0, shape),
                pressure_pa=rng.uniform(90000.0, 101500.0, shape),
                mean_month_t_c=rng.uniform(12.0, 24.0, shape),
                stress_profile=stress, root_density=np.broadcast_to(roots, roots.shape),
                stage=rng.uniform(2.0, 5.5, shape))


def _pair(env, keys):
    return ({k: jnp.asarray(env[k]) for k in keys}, {k: _t(env[k]) for k in keys})


def _canopy_pieces(env):
    """JAX's weather, radiation and the two big leaves of the seeded maps."""
    wx = JV.weather_variables(*(jnp.asarray(env[k])
                                for k in ("t_air_c", "rh_pct", "cloudiness")))
    rad = JV.radiation_absorption(
        jnp.asarray(env["lai"]), jnp.asarray(env["sun_elevation_deg"]),
        jnp.asarray(env["direct_irr"]), jnp.asarray(env["diffuse_irr"]),
        jnp.asarray(env["t_air_c"]), wx["longwave_irr"], wx["emissivity_sky"])
    leaf_t = jnp.asarray(env["t_air_c"]) + 273.15
    sunlit, shaded = JV.upscale(rad, leaf_t, leaf_t, jnp.asarray(env["mean_month_t_c"]),
                                jnp.asarray(env["pressure_pa"]),
                                JV.WangLeuningParameters())
    return wx, rad, sunlit, shaded


def test_weather_radiation_aerodynamics_upscale_match_jax():
    env = canopy_env()
    jwx, _, jsun, jsh = _canopy_pieces(env)
    keys = ("t_air_c", "rh_pct", "cloudiness")
    twx = TV.weather_variables(*(_t(env[k]) for k in keys))
    assert_dicts(twx, jwx, label="weather")
    args = ("lai", "sun_elevation_deg", "direct_irr", "diffuse_irr", "t_air_c")
    jrad = JV.radiation_absorption(*(jnp.asarray(env[k]) for k in args),
                                   jwx["longwave_irr"], jwx["emissivity_sky"])
    trad = TV.radiation_absorption(*(_t(env[k]) for k in args),
                                   twx["longwave_irr"], twx["emissivity_sky"])
    assert_dicts(trad, jrad, label="radiation")
    jlw = JV.leaf_width_for_stage(jnp.asarray(env["stage"]))
    tlw = TV.leaf_width_for_stage(_t(env["stage"]))
    close(tlw, jlw, name="leaf width")
    for amph in (True, False):
        jaero = JV.aerodynamic_conductances(
            jnp.asarray(env["wind_speed"]), jnp.asarray(env["lai"]), jnp.float64(1.8),
            jnp.asarray(env["t_air_c"]), jnp.asarray(env["pressure_pa"]),
            jrad["lai_sunlit"], jwx["slope_sat_vp"], leaf_width=jlw, amphystomatic=amph)
        taero = TV.aerodynamic_conductances(
            _t(env["wind_speed"]), _t(env["lai"]), torch.tensor(1.8, dtype=torch.float64),
            _t(env["t_air_c"]), _t(env["pressure_pa"]), trad["lai_sunlit"],
            twx["slope_sat_vp"], leaf_width=tlw, amphystomatic=amph)
        assert_dicts(taero, jaero, label=f"aerodynamics {amph}")
    leaf_t = _t(env["t_air_c"]) + 273.15
    for wl in (TV.WangLeuningParameters(),
               TV.WangLeuningParameters(max_carbox_rate=108.0, alpha=9e5)):
        jw = JV.WangLeuningParameters(**dataclasses.asdict(wl))
        j_sun, j_sh = JV.upscale(jrad, jnp.asarray(leaf_t.numpy()),
                                 jnp.asarray(leaf_t.numpy()),
                                 jnp.asarray(env["mean_month_t_c"]),
                                 jnp.asarray(env["pressure_pa"]), jw)
        t_sun, t_sh = TV.upscale(trad, leaf_t, leaf_t, _t(env["mean_month_t_c"]),
                                 _t(env["pressure_pa"]), wl)
        assert_dicts(t_sun, j_sun, label="upscale sunlit")
        assert_dicts(t_sh, j_sh, label="upscale shaded")
    for year in (1985, 2023):
        close(TV.atmospheric_co2_pa(year, torch.tensor(172.0, dtype=torch.float64),
                                    _t(env["pressure_pa"])),
              JV.atmospheric_co2_pa(year, jnp.float64(172.0), jnp.asarray(env["pressure_pa"])),
              name=f"co2 {year}")


@pytest.mark.parametrize("leaf", ["sunlit", "shaded"])
@pytest.mark.parametrize("stressed", [True, False])
def test_kernel_simplified_matches_jax(leaf, stressed):
    """The fixed point on the seeded big leaves: stressed over the (L, R, C)
    layer profile (alpha x saw stress) or unstressed: outputs rel 1e-12 and
    the same per-cell stop iteration as JAX (cells that never stop run to
    max_iter in both)."""
    env = canopy_env()
    jwx, _, jsun, jsh = _canopy_pieces(env)
    jleaf = jsun if leaf == "sunlit" else jsh
    tleaf = {k: _t(np.asarray(v)) for k, v in jleaf.items()}
    alpha = 1e6
    stomwl = alpha * env["stress_profile"] if stressed else np.float64(alpha)
    co2 = np.asarray(JV.atmospheric_co2_pa(2023, jnp.float64(172.0),
                                           jnp.asarray(env["pressure_pa"])))
    kw = dict(co2_pa=co2, pressure_pa=env["pressure_pa"], vpd_pa=np.asarray(jwx["vpd"]))
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    tkw = {k: _t(v) for k, v in kw.items()}
    jout = JV.photosynthesis_kernel_simplified(jleaf, stomwl=jnp.asarray(stomwl),
                                               vpd_sensitivity=1300.0, **jkw)
    *tout, info = TV.photosynthesis_kernel_simplified(
        tleaf, stomwl=_t(stomwl), vpd_sensitivity=1300.0, return_stop=True, **tkw)
    for a, b, name in zip(tout, jout, ("ass", "gsc", "tr")):
        close(a, b, name=f"{leaf} {stressed} {name}")
    stop = info["stop"]
    never = int((stop < 0).sum())
    flips = stop_flips(
        lambda m: JV.photosynthesis_kernel_simplified(
            jleaf, stomwl=jnp.asarray(stomwl), vpd_sensitivity=1300.0, max_iter=m, **jkw),
        stop, info["d_ass"], jout)
    print(f"{leaf} stressed={stressed}: stop iterations "
          f"{sorted(set(stop.reshape(-1).tolist()))}, never stopping {never} of "
          f"{stop.numel()}, loop iterations {info['iterations']}, flipped cells {flips}")
    assert flips == 0, f"{flips} cells stop at another iteration than JAX's"


@pytest.mark.parametrize("max_iter", [30, 1000])
def test_fixed_point_machine_matches_jax(max_iter):
    """The vine's fixed point as a machine (physics/fixed_point.py) under
    the eager driver, the CPU's, on the stressed sunlit leaves: at max_iter
    30 (the bootstrap, then 7 units of CHECK_EVERY iterations and one of
    the last 1) and at 1,000 some cells run to max_iter, as in JAX; each
    stopped cell's stop iteration JAX's (0 flips), the outputs rel 1e-12
    against JAX cut at the same max_iter, the loop's iteration count JAX's
    (from 1); one host read a unit."""
    import math
    from criteria3d_tpu_torch.solver import device_loop
    env = canopy_env()
    jwx, _, jsun, _ = _canopy_pieces(env)
    tleaf = {k: _t(np.asarray(v)) for k, v in jsun.items()}
    stomwl = 1e6 * env["stress_profile"]
    co2 = np.asarray(JV.atmospheric_co2_pa(2023, jnp.float64(172.0),
                                           jnp.asarray(env["pressure_pa"])))
    kw = dict(co2_pa=co2, pressure_pa=env["pressure_pa"], vpd_pa=np.asarray(jwx["vpd"]))
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    jout = JV.photosynthesis_kernel_simplified(jsun, stomwl=jnp.asarray(stomwl),
                                               vpd_sensitivity=1300.0, max_iter=max_iter,
                                               **jkw)
    device_loop.reset_counts()
    *tout, info = TV.photosynthesis_kernel_simplified(
        tleaf, stomwl=_t(stomwl), vpd_sensitivity=1300.0, max_iter=max_iter,
        return_stop=True, **{k: _t(v) for k, v in kw.items()})
    counts = device_loop.counts()
    for a, b, name in zip(tout, jout, ("ass", "gsc", "tr")):
        close(a, b, name=f"max_iter {max_iter} {name}")
    stop = info["stop"]
    running = int((stop < 0).sum())
    assert running > 0 and int((stop >= 0).sum()) > 0
    assert info["iterations"] == max_iter - 1
    assert counts["eager_fixed_points"] == 1
    assert counts["eager_reads"] == math.ceil(info["iterations"] / TV.CHECK_EVERY)
    flips = stop_flips(
        lambda m: JV.photosynthesis_kernel_simplified(
            jsun, stomwl=jnp.asarray(stomwl), vpd_sensitivity=1300.0, max_iter=m, **jkw),
        stop, info["d_ass"], jout)
    print(f"max_iter {max_iter}: stop iterations {sorted(set(stop.reshape(-1).tolist()))}, "
          f"{running} cells at max_iter, flipped cells {flips}")
    assert flips == 0, f"{flips} cells stop at another iteration than JAX's"


def test_canopy_fluxes_and_respiration_match_jax():
    """vine_canopy_fluxes (JAX's jitted chain) on the seeded maps with the
    stage's leaf width, two cultivars; plant respiration and the
    temperature-moisture factor: rel 1e-12."""
    env = canopy_env()
    keys = [k for k in env if k != "stage"]
    jin, tin = _pair(env, keys)
    for params in (TV.WangLeuningParameters(),
                   TV.WangLeuningParameters(max_carbox_rate=108.0, alpha=9e5,
                                            vpd_sensitivity=1200.0)):
        jp = JV.WangLeuningParameters(**dataclasses.asdict(params))
        jout = JV.vine_canopy_fluxes(year=2023, doy=172, params=jp,
                                     stage=jnp.asarray(env["stage"]), **jin)
        tout = TV.vine_canopy_fluxes(year=2023, doy=172, params=params,
                                     stage=_t(env["stage"]), **tin)
        jaero, taero = jout.pop("aerodynamics"), tout.pop("aerodynamics")
        assert_dicts(tout, jout, label="canopy")
        assert_dicts(taero, jaero, label="canopy aerodynamics")
    rng = np.random.default_rng(10)
    shape = (4, 6)
    arr = dict(cumulated_biomass=rng.uniform(0.0, 2.0, shape),
               fruit_biomass=rng.uniform(0.0, 0.5, shape),
               days_after_bloom=rng.uniform(0.0, 3.0, shape),
               t_air_c=rng.uniform(5.0, 35.0, shape))
    for psi in (-100.0, -20.0, -2000.0):
        kw = dict(psi_soil_avg=psi, psi_fc_avg=-33.0, wilting_point=-1500.0)
        close(TV.plant_respiration(mean_month_t_c=15.0, **{k: _t(v) for k, v in arr.items()}, **kw),
              JV.plant_respiration(mean_month_t_c=15.0,
                                   **{k: jnp.asarray(v) for k, v in arr.items()}, **kw),
              name=f"respiration {psi}")
        t_k = _t(arr["t_air_c"]) + 273.15
        close(TV.temperature_moisture_factor(t_k, **kw),
              JV.temperature_moisture_factor(jnp.asarray(t_k.numpy()), **kw),
              name=f"factor {psi}")


# ----------------------------------------------------------------------
# the mildews (float32)
# ----------------------------------------------------------------------

def ulps(t: torch.Tensor, j) -> int:
    """The largest distance in float32 ulps between two float32 arrays."""
    a = t.numpy().astype(np.float32).reshape(-1)
    b = np.asarray(j).astype(np.float32).reshape(-1)
    if a.size == 0:
        return 0
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(np.abs(ia - ib).max())


def close32(a: torch.Tensor, b, ulp=ULP32, scale=0.0) -> None:
    """Within ``ulp`` float32 ulps of ``max(|b|, scale)`` elementwise:
    ``scale`` is the size of the terms ``b`` is a difference of."""
    b = np.asarray(b)
    size = np.maximum(np.abs(b), scale).astype(np.float32)
    diff = np.abs(a.numpy().astype(np.float64) - b.astype(np.float64))
    assert (diff <= ulp * np.spacing(size).astype(np.float64)).all(), \
        (ulps(a, b), float(diff.max()))


def assert_state32(ts, js, label, ulp=ULP32, scales=None):
    """Every field: dtype equal; integer and bool fields equal; float32
    fields within ``ulp`` float32 ulps (of ``scales[name]`` where a field
    is a difference of terms of that size); float64 fields within ``ulp``
    float32 ulps of the field's max (they carry float32 inputs)."""
    scales = scales or {}
    for f in dataclasses.fields(js):
        a, b = getattr(ts, f.name), np.asarray(getattr(js, f.name))
        assert dtype_name(a) == b.dtype.name, (label, f.name)
        if b.dtype.kind in "bi":
            np.testing.assert_array_equal(a.numpy(), b, err_msg=f"{label} {f.name}")
        elif b.dtype == np.float32:
            close32(a, b, ulp, scales.get(f.name, 0.0))
        else:
            scale = max(float(np.abs(b).max()) if b.size else 0.0,
                        scales.get(f.name, 0.0))
            np.testing.assert_allclose(a.numpy(), b, rtol=ulp * 2.0 ** -23,
                                       atol=ulp * 2.0 ** -23 * scale,
                                       err_msg=f"{label} {f.name}")


def downy_weather(hour: int):
    """tests/test_downy_mildew.py's warm wet spring (rain every 6 h) and
    dry spell, as float32 maps on a 3 x 3 block with seeded variation."""
    rng = np.random.default_rng(hour)
    wet = hour < 24 * 12
    shape = (3, 3)
    f = lambda v, s: (v + rng.normal(0.0, s, shape)).astype(np.float32)  # noqa: E731
    return dict(tair=f(20.0 if wet else 22.0, 1.5),
                rain=np.maximum(f(1.0 if (wet and hour % 6 == 0) else 0.0, 0.05), 0.0),
                leaf_wetness=np.full(shape, 1.0 if wet else 0.0, np.float32),
                relative_humidity=np.clip(f(95.0 if wet else 40.0, 3.0), 0.0, 100.0))


def test_downy_mildew_functions_match_jax():
    for t in (-2.0, 5.0, 20.0):
        for llm in (0.0, 1.0):
            j = JD.hydrothermal_time(jnp.float32(t), llm)
            a = TD.hydrothermal_time(torch.tensor(t, dtype=torch.float32), llm)
            assert dtype_name(a) == np.asarray(j).dtype.name and ulps(a, j) <= ULP32
    h = np.linspace(0, 10, 20)
    close(TD.dormancy_breaking(_t(h)), JD.dormancy_breaking(jnp.asarray(h)),
          name="dormancy f64")
    h32 = h.astype(np.float32)
    assert ulps(TD.dormancy_breaking(torch.from_numpy(h32)),
                JD.dormancy_breaking(jnp.asarray(h32))) <= ULP32
    t = np.linspace(-5, 35, 17).astype(np.float32)
    rh = np.linspace(0, 100, 17).astype(np.float32)
    assert ulps(TD.vapour_pressure_deficit(torch.from_numpy(t), torch.from_numpy(rh)),
                JD.vapour_pressure_deficit(jnp.asarray(t), jnp.asarray(rh))) <= ULP32
    assert ulps(TD.vapour_pressure_deficit(torch.from_numpy(t), 80.0),
                JD.vapour_pressure_deficit(jnp.asarray(t), 80.0)) <= ULP32


def test_downy_mildew_steps_match_jax():
    """Twelve days of tests/test_downy_mildew.py's wet spring then three
    dry days, hour by hour on a 3 x 3 block (first hour on Jan 1): each
    step from JAX's state; the cohorts go through germination, sporangia,
    zoospores, infection and oil spots."""
    js = JD.DownyMildewState.initialize((3, 3))
    seen_stages, infected, oil = set(), False, 0.0
    pmo_scale = 0.0
    for hour in range(24 * 15):
        w = downy_weather(hour)
        ts = convert.downy_state_from_arrays(to_arrays(js), device="cpu")
        first = hour == 0
        js, jo = JD.downy_mildew_step(
            js, JD.DownyMildewInput(**{k: jnp.asarray(v) for k, v in w.items()}), first)
        ts, to = TD.downy_mildew_step(
            ts, TD.DownyMildewInput(**{k: torch.from_numpy(v) for k, v in w.items()}), first)
        # the mature oospores (and the cohorts and rates made of them) are
        # differences of dormancy_breaking values p up to 1 - mmo, each
        # conditioned as p (1 + |ln p|)
        p = float(np.max(1.0 - np.asarray(jo["mmo"])))
        pmo_scale = max(pmo_scale, p * (1.0 + abs(np.log(max(p, 1e-30)))))
        pmo = dict(current_pmo=pmo_scale, cohort=pmo_scale)
        assert_state32(ts, js, f"hour {hour}", scales=pmo)
        np.testing.assert_array_equal(to["is_infection"].numpy(),
                                      np.asarray(jo["is_infection"]))
        for k in ("infection_rate", "oil_spots", "oil_spots_total", "mmo"):
            assert dtype_name(to[k]) == np.asarray(jo[k]).dtype.name, k
            close32(to[k], jo[k], scale=0.0 if k == "mmo" else pmo_scale)
        seen_stages |= set(np.unique(np.asarray(js.stage)).tolist())
        infected |= bool(np.asarray(jo["is_infection"]).any())
        oil = max(oil, float(np.asarray(jo["oil_spots"]).max()))
    assert seen_stages >= {0, 1, 2, 3, 4, 5} and infected and oil > 0.0


def test_powdery_mildew_steps_match_jax():
    """tests/test_powdery_mildew.py's 120-day season (numbers: weakly
    typed, the step stays float32) and the VINE3D form (float64 maps of
    rain, leaf wetness and humidity promote the pools to float64), each
    day from JAX's state; the 30 cold days do nothing in both."""
    # fractions of the ascospore pool: 4 ulp of the whole pool
    pool = dict(aic=1.0, current_colonies=1.0, total_sporulating=1.0)
    pool_out = ("aol", "col", "infection_risk")
    js = JPM.PowderyMildewState.initialize()
    ts = TPM.PowderyMildewState.initialize(device="cpu")
    assert_state32(ts, js, "initialize", ulp=0)
    for day in range(120):
        kw = dict(tavg=18.0, rain=5.0 if day % 7 == 0 else 0.0, leaf_wetness=8.0,
                  relative_humidity=80.0, is_bud_break=day == 0)
        ts = convert.powdery_state_from_arrays(to_arrays(js), device="cpu")
        js, jo = JPM.powdery_mildew_step(js, **kw)
        ts, to = TPM.powdery_mildew_step(ts, **kw)
        assert_state32(ts, js, f"day {day}", scales=pool)
        for k, v in jo.items():
            assert dtype_name(to[k]) == np.asarray(v).dtype.name, k
            if np.asarray(v).dtype == np.bool_:
                assert bool(to[k]) == bool(v), (day, k)
            else:
                close32(to[k], v, scale=1.0 if k in pool_out else 0.0)
    rng = np.random.default_rng(13)
    shape = (3, 4)
    js = JPM.PowderyMildewState.initialize(shape)
    for day in range(40):
        arr = dict(tavg=rng.uniform(0.0, 33.0, shape), rain=rng.uniform(0.0, 6.0, shape),
                   leaf_wetness=rng.uniform(0.0, 24.0, shape),
                   relative_humidity=rng.uniform(30.0, 100.0, shape))
        ts = convert.powdery_state_from_arrays(to_arrays(js), device="cpu")
        js, jo = JPM.powdery_mildew_step(js, **{k: jnp.asarray(v) for k, v in arr.items()},
                                         is_bud_break=day == 0)
        ts, to = TPM.powdery_mildew_step(ts, **{k: _t(v) for k, v in arr.items()},
                                         is_bud_break=day == 0)
        assert_state32(ts, js, f"map day {day}", scales=pool)
        for k in ("day_infection", "day_sporulation"):
            np.testing.assert_array_equal(to[k].numpy(), np.asarray(jo[k]))
    assert np.asarray(js.aic).dtype == np.float64
    js = JPM.PowderyMildewState.initialize()
    ts = TPM.PowderyMildewState.initialize(device="cpu")
    for day in range(30):
        kw = dict(tavg=2.0, rain=5.0, leaf_wetness=8.0, relative_humidity=90.0,
                  is_bud_break=day == 0)
        js, jo = JPM.powdery_mildew_step(js, **kw)
        ts, to = TPM.powdery_mildew_step(ts, **kw)
        assert float(to["col"]) == float(jo["col"]) == 0.0
    assert_state32(ts, js, "cold", ulp=0)

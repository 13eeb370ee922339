"""The port's process physics of the hourly model cycle against the JAX
package, module by module: meteo, radiation (sun position, the shadow
march, the whole-DEM driver), snow, interception, cracking and crop.

Both implementations get the same seeded numpy inputs; the port runs on
the CPU. Tolerance: rel 1e-12 on float64 (ulps of two libraries' exp, log,
trigonometric functions and pow), with an absolute floor of 1e-12 times the
field's max |value| where a field is 0 or cancels. Boolean maps are held
equal; where a map is a comparison on a threshold (``sunlit``,
``frozen_pack``, ``cracked``), the test counts the cells that flip and
requires none.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

import criteria3d_tpu as J
from criteria3d_tpu.core.grid import slope_aspect
from criteria3d_tpu.physics import cracking as Jcr
from criteria3d_tpu.physics import crop as Jc
from criteria3d_tpu.physics import interception as Ji
from criteria3d_tpu.physics import meteo as Jm
from criteria3d_tpu.physics import radiation as Jr
from criteria3d_tpu.physics import snow as Js
from criteria3d_tpu_torch.physics import cracking as Tcr
from criteria3d_tpu_torch.physics import crop as Tc
from criteria3d_tpu_torch.physics import interception as Ti
from criteria3d_tpu_torch.physics import meteo as Tm
from criteria3d_tpu_torch.physics import radiation as Tr
from criteria3d_tpu_torch.physics import snow as Ts
import criteria3d_tpu_torch as T
from tests.test_catchment3d import valley_dem
from tests.test_torch_core import build_grids, dtype_name

torch.set_num_threads(1)

F64 = 1e-12


def close(t, j, rtol=F64, name=""):
    """Port tensor ``t`` against JAX array ``j``: dtypes equal, values
    within ``rtol`` with an absolute floor of ``rtol`` x max |value|."""
    if isinstance(t, torch.Tensor):
        assert dtype_name(t) == dtype_name(j), name
        t = t.numpy()
    a = np.asarray(j)
    assert np.shape(t) == a.shape, name
    scale = float(np.nanmax(np.abs(a))) if a.size and np.isfinite(a).any() else 0.0
    np.testing.assert_allclose(t, a, rtol=rtol, atol=rtol * scale, err_msg=name)
    if scale > 0:   # the measured gap, shown with pytest -s
        print(f"{name}: max |port - jax| / max |jax| = "
              f"{float(np.nanmax(np.abs(t - a))) / scale}")


def pair(a):
    """The same numpy array for both packages."""
    a = np.asarray(a, dtype=np.float64)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def flips(t_bool, j_bool) -> int:
    return int((t_bool.numpy() != np.asarray(j_bool)).sum())


# ----------------------------------------------------------------------
# meteo
# ----------------------------------------------------------------------

def _meteo_inputs(seed=0, n=400):
    rng = np.random.default_rng(seed)
    return dict(
        t=rng.uniform(-25.0, 40.0, n), t2=rng.uniform(-25.0, 40.0, n),
        rh=rng.uniform(5.0, 100.0, n), h=rng.uniform(-50.0, 3000.0, n),
        tk=rng.uniform(250.0, 310.0, n), vp=rng.uniform(50.0, 4000.0, n),
        kpa=rng.uniform(0.1, 4.0, n), trans=rng.uniform(0.0, 1.3, n),
        irr=rng.uniform(0.0, 1100.0, n), wind=rng.uniform(0.0, 12.0, n),
        lat=rng.uniform(-66.0, 66.0, n), doy=rng.integers(1, 366, n),
        dirn=rng.uniform(0.0, 360.0, n), u=rng.uniform(-8.0, 8.0, n),
        v=rng.uniform(-8.0, 8.0, n), net=rng.uniform(-150.0, 800.0, n),
        sw=rng.uniform(0.5, 32.0, n))


METEO_CASES = {
    "saturation_vapor_pressure": lambda m, x: m.saturation_vapor_pressure(x["t"]),
    "saturation_slope": lambda m, x: m.saturation_slope(x["t"], x["kpa"]),
    "pressure_from_altitude": lambda m, x: m.pressure_from_altitude(x["h"]),
    "latent_heat_vaporization": lambda m, x: m.latent_heat_vaporization(x["t"]),
    "dew_point_from_rh": lambda m, x: m.dew_point_from_rh(x["t"], x["rh"]),
    "rh_from_dew_point": lambda m, x: m.rh_from_dew_point(x["t"], x["t2"]),
    "psychrometric_constant": lambda m, x: m.psychrometric_constant(x["kpa"], x["t"]),
    "air_density": lambda m, x: m.air_density(x["tk"]),
    "air_density_pressure": lambda m, x: m.air_density(x["tk"], x["vp"] * 25.0),
    "vapor_concentration": lambda m, x: m.vapor_concentration_from_pressure(x["vp"], x["tk"]),
    "emissivity_from_vapor_pressure": lambda m, x: m.emissivity_from_vapor_pressure(x["kpa"]),
    "atmospheric_emissivity_brutsaert": lambda m, x: m.atmospheric_emissivity_brutsaert(x["vp"], x["tk"]),
    "et0_penman_hourly": lambda m, x: m.et0_penman_hourly(
        x["h"], x["trans"], x["irr"], x["t"], x["rh"], x["wind"]),
    "daily_extraterrestrial_radiation": lambda m, x: m.daily_extraterrestrial_radiation(
        x["lat"], x["doy"]),
    "et0_hargreaves_daily": lambda m, x: m.et0_hargreaves_daily(
        0.17, x["lat"], x["doy"], x["t"] + 8.0, x["t"]),
    "thom_index": lambda m, x: m.thom_index(x["t"], x["rh"]),
    "daily_bic": lambda m, x: m.daily_bic(x["rh"], x["kpa"]),
    "daily_thermal_range": lambda m, x: m.daily_thermal_range(x["t"], x["t2"]),
    "heating_degree_days": lambda m, x: m.heating_degree_days(x["t"]),
    "cooling_degree_days": lambda m, x: m.cooling_degree_days(x["t"]),
    "wind_cartesian": lambda m, x: m.wind_cartesian(x["wind"], x["dirn"]),
    "wind_polar": lambda m, x: m.wind_polar(x["u"], x["v"]),
    "et0_penman_daily": lambda m, x: m.et0_penman_daily(
        x["doy"], x["h"], x["lat"], x["t"], x["t"] + 9.0, x["wind"], x["rh"], x["sw"]),
    "et0_penman_hourly_net_rad": lambda m, x: m.et0_penman_hourly_net_rad(
        x["h"], x["net"], x["t"], x["rh"], x["wind"]),
}


@pytest.mark.parametrize("name", sorted(METEO_CASES))
def test_meteo_matches_jax(name):
    """Every meteo function on 400 seeded float64 inputs: rel 1e-12."""
    x = _meteo_inputs()
    jx = {k: jnp.asarray(v) for k, v in x.items()}
    tx = {k: torch.from_numpy(np.array(v)) for k, v in x.items()}
    j, t = METEO_CASES[name](Jm, jx), METEO_CASES[name](Tm, tx)
    if isinstance(j, tuple):
        for jj, tt in zip(j, t):
            close(tt, jj, name=name)
    else:
        close(t, j, name=name)


# ----------------------------------------------------------------------
# radiation
# ----------------------------------------------------------------------

SUN_CASES = {
    "night": (2023, 1, 15, 2),
    "sunrise": (2023, 3, 21, 6),
    "morning": (2023, 3, 21, 7),
    "noon_summer": (2024, 6, 21, 12),
    "leap_autumn": (2024, 10, 3, 16),
    "high_latitude": (2023, 12, 21, 12),
}


@pytest.mark.parametrize("case", sorted(SUN_CASES))
def test_sun_position_matches_jax(case):
    """sun_position over a lat/lon grid (and a 60-80 N grid for the high
    latitude case), seeded slope/aspect and pressure: rel 1e-12, and the
    refraction, air-mass and sunrise branches taken the same way."""
    year, month, day, hour = SUN_CASES[case]
    lat0 = 60.0 if case == "high_latitude" else -50.0
    lats, lons = np.meshgrid(np.linspace(lat0, lat0 + 20.0 if lat0 > 0 else 70.0, 9),
                             np.linspace(-20.0, 40.0, 7), indexing="ij")
    rng = np.random.default_rng(1)
    slope = rng.uniform(0.0, 40.0, lats.shape)
    aspect = rng.uniform(0.0, 360.0, lats.shape)
    press = rng.uniform(700.0, 1013.0, lats.shape)
    (jl, tl), (jo, to), (js, ts), (ja, ta), (jp, tp) = map(
        pair, (lats, lons, slope, aspect, press))
    j = Jr.sun_position(jl, jo, 1, year, month, day, hour, pressure_hpa=jp,
                        aspect_deg=ja, slope_deg=js)
    t = Tr.sun_position(tl, to, 1, year, month, day, hour, pressure_hpa=tp,
                        aspect_deg=ta, slope_deg=ts)
    assert sorted(t) == sorted(j)
    for k in j:
        close(t[k], j[k], name=k)
    for k, thr in (("elevation_refr", 0.0), ("incidence", 0.0), ("elevation", 5.0)):
        assert flips(t[k] > thr, j[k] > thr) == 0, k


def seeded_dem(seed=0, R=40, C=50, cell=10.0):
    """A rough seeded DEM with a nodata corner: ridges up to ~60 m."""
    rng = np.random.default_rng(seed)
    rows, cols = np.mgrid[0:R, 0:C].astype(np.float64)
    z = 300.0 + 0.8 * rows * cell * 0.1 + 20.0 * np.sin(cols / 4.0) \
        + 15.0 * np.cos(rows / 5.0 + cols / 7.0) + rng.normal(0.0, 2.0, (R, C))
    z[:4, :5] = -9999.0
    return z


def test_shadow_map_matches_jax():
    """shadow_map on a seeded 40 x 50 DEM at 16 azimuths x 4 elevations:
    boolean maps equal (no flipped cell)."""
    dem = seeded_dem()
    valid = ~np.isclose(dem, -9999.0)
    jd, td = pair(dem)
    jv, tv = jnp.asarray(valid), torch.from_numpy(valid)
    shaded = 0
    for az in np.linspace(0.0, 360.0, 16, endpoint=False) + 7.3:
        for el in (0.5, 3.8, 12.0, 35.0):
            j = Jr.shadow_map(jd, jv, 10.0, float(az), el)
            t = Tr.shadow_map(td, tv, 10.0, float(az), el)
            assert t.dtype == torch.bool
            assert flips(t, j) == 0, (az, el)
            shaded += int(t.sum())
    assert shaded > 0                   # the march does shade cells
    # at or below the horizon every valid cell is in shadow
    assert torch.equal(Tr.shadow_map(td, tv, 10.0, 90.0, -1.0), tv)


RAD_CASES = {
    "clear_sky_shadowed": dict(trans=None, shadowing=True, when=(2023, 3, 21, 7)),
    "real_sky_shadowed": dict(trans=0.45, shadowing=True, when=(2023, 6, 21, 9)),
    "real_sky_unshadowed": dict(trans=0.7, shadowing=False, when=(2023, 10, 5, 15)),
    "night": dict(trans=0.7, shadowing=True, when=(2023, 3, 21, 3)),
}


@pytest.mark.parametrize("case", sorted(RAD_CASES))
def test_compute_radiation_dem_matches_jax(case):
    """compute_radiation_dem on the seeded DEM with slope/aspect from
    slope_aspect (the inclined beam, Muneer diffuse and reflected terms
    run), with and without a transmissivity map and shadowing: every map
    rel 1e-12, the sunlit mask without a flip, three host reads with
    shadowing and none without."""
    from criteria3d_tpu_torch.device import host_read
    kw = RAD_CASES[case]
    dem = seeded_dem(3)
    valid = ~np.isclose(dem, -9999.0)
    slope, aspect = slope_aspect(dem, 10.0)
    slope = np.where(valid, slope, 0.0)
    aspect = np.where(valid, aspect, 0.0)
    rng = np.random.default_rng(4)
    trans = None if kw["trans"] is None else \
        np.clip(kw["trans"] + rng.uniform(-0.1, 0.1, dem.shape), 0.05, 1.0)
    jd, td = pair(dem)
    jv, tv = jnp.asarray(valid), torch.from_numpy(valid)
    (jla, tla), (jlo, tlo), (js, ts), (ja, ta) = map(
        pair, (np.full(dem.shape, 44.5), np.full(dem.shape, 11.3), slope, aspect))
    common = dict(linke=3.5, albedo=0.2, clear_sky_transmissivity=0.75,
                  shadowing=kw["shadowing"])
    jt, tt = (None, None) if trans is None else pair(trans)
    j = Jr.compute_radiation_dem(jd, jv, 10.0, jla, jlo, js, ja, 1, *kw["when"],
                                 transmissivity=jt, **common)
    host_read.count = 0
    t = Tr.compute_radiation_dem(td, tv, 10.0, tla, tlo, ts, ta, 1, *kw["when"],
                                 transmissivity=tt, **common)
    assert host_read.count == (3 if kw["shadowing"] else 0)
    for name in ("global_irr", "beam", "diffuse", "reflected"):
        close(getattr(t, name), getattr(j, name), name=name)
    for k in j.sun:
        close(t.sun[k], j.sun[k], name=k)
    # the sunlit decision of the driver, recomputed from the same pieces
    j_lit = np.asarray(j.beam) > 0
    t_lit = t.beam > 0
    assert flips(t_lit, j_lit) == 0
    if case != "night":
        assert float(t.global_irr.max()) > 50.0


# ----------------------------------------------------------------------
# snow
# ----------------------------------------------------------------------

SNOW_FIELDS = ("swe", "ice", "liquid", "internal_energy", "surface_energy",
               "surface_temp", "age")
FORCING_FIELDS = ("air_temp", "precipitation", "rel_humidity", "wind_speed",
                  "global_radiation", "beam_radiation", "transmissivity",
                  "clear_sky_transmissivity", "surface_water")


def random_snow(seed, shape=(24, 20)):
    """Seeded snow states and forcing covering the branches: no snow, a
    pack with ice/liquid, a pack needing the ice/liquid reset, the soil
    internal-energy fix, cells over 100 mm of free water, NODATA
    transmissivity."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    kind = rng.integers(0, 5, n)
    swe = np.where(kind == 0, 0.0, rng.uniform(0.0, 120.0, n))
    ice = np.where(kind == 2, 0.0, swe * rng.uniform(0.85, 0.98, n))
    liquid = np.where(kind == 2, 0.0, swe - ice)
    st = rng.uniform(-12.0, 6.0, n)
    ie = np.where(kind == 3, rng.uniform(-9000.0, 9000.0, n),
                  st * 1350.0 * 1.4 * 0.3 + rng.normal(0.0, 50.0, n))
    se = st * 1000.0 * 2.1 * 0.02
    age = np.where(swe > 0, rng.uniform(0.0, 20.0, n), -9999.0)
    state = dict(swe=swe, ice=ice, liquid=liquid, internal_energy=ie,
                 surface_energy=se, surface_temp=st, age=age)
    trans = rng.uniform(0.1, 0.8, n)
    trans[rng.random(n) < 0.1] = -9999.0
    glob = rng.uniform(0.0, 800.0, n)
    forcing = dict(
        air_temp=rng.uniform(-15.0, 10.0, n),
        precipitation=np.where(rng.random(n) < 0.5, rng.uniform(0.0, 12.0, n), 0.0),
        rel_humidity=rng.uniform(30.0, 100.0, n),
        wind_speed=rng.uniform(0.0, 14.0, n),
        global_radiation=glob, beam_radiation=glob * rng.uniform(0.0, 0.8, n),
        transmissivity=trans, clear_sky_transmissivity=np.full(n, 0.75),
        surface_water=np.where(rng.random(n) < 0.1, rng.uniform(100.0, 300.0, n),
                               rng.uniform(-1.0, 20.0, n)))
    rs = lambda d: {k: v.reshape(shape) for k, v in d.items()}
    return rs(state), rs(forcing)


def _snow_pair(state, forcing):
    js = Js.SnowState(**{k: jnp.asarray(v) for k, v in state.items()})
    ts = Ts.SnowState(**{k: torch.from_numpy(np.array(v)) for k, v in state.items()})
    jf = Js.SnowForcing(**{k: jnp.asarray(v) for k, v in forcing.items()})
    tf = Ts.SnowForcing(**{k: torch.from_numpy(np.array(v)) for k, v in forcing.items()})
    return js, ts, jf, tf


@pytest.mark.parametrize("compat", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_snow_step_matches_jax(seed, compat):
    """One snow step on seeded states covering the reset, fix_ie and
    free-water branches, with both compat_enum_snow_ratio values: every
    state field and output rel 1e-12, no flipped frozen_pack cell."""
    state, forcing = random_snow(seed)
    js, ts, jf, tf = _snow_pair(state, forcing)
    jp = Js.SnowParameters(compat_enum_snow_ratio=compat)
    tp = Ts.SnowParameters(compat_enum_snow_ratio=compat)
    jn, jo = Js.snow_step(js, jf, jp)
    tn, to = Ts.snow_step(ts, tf, tp)
    for f in SNOW_FIELDS:
        close(getattr(tn, f), getattr(jn, f), name=f)
    assert sorted(to) == sorted(jo)
    for k in jo:
        close(to[k], jo[k], name=k)
    assert flips(tn.swe > 0, jn.swe > 0) == 0
    # the branches were taken
    assert (forcing["surface_water"] > 100.0).any()
    assert ((state["swe"] > 0) & (state["ice"] <= 0)).any()


def test_snow_trajectory_48h_matches_jax():
    """48 chained hours (a cold snowy night, a thaw with rain, a clear
    afternoon): SWE rel 1e-12 of its max at every hour."""
    shape = (12, 10)
    rng = np.random.default_rng(7)
    zs = Js.SnowState.zero(shape, surface_temp=-2.0)
    ts = Ts.SnowState.zero(shape, surface_temp=-2.0, device="cpu")
    jstate, tstate = zs, ts
    for h in range(48):
        t_air = -6.0 + 10.0 * np.sin(np.pi * (h - 8) / 24.0) + rng.normal(0, 0.5, shape)
        prec = np.full(shape, 3.0 if h % 24 < 10 else 0.0)
        glob = np.full(shape, max(0.0, 600.0 * np.sin(np.pi * (h % 24 - 6) / 12.0)))
        forcing = dict(air_temp=t_air, precipitation=prec,
                       rel_humidity=np.full(shape, 85.0), wind_speed=np.full(shape, 3.0),
                       global_radiation=glob, beam_radiation=0.6 * glob,
                       transmissivity=np.full(shape, 0.5),
                       clear_sky_transmissivity=np.full(shape, 0.75),
                       surface_water=np.zeros(shape))
        _, _, jf, tf = _snow_pair({k: np.zeros(shape) for k in SNOW_FIELDS}, forcing)
        jstate, _ = Js.snow_step(jstate, jf)
        tstate, _ = Ts.snow_step(tstate, tf)
        for f in SNOW_FIELDS:
            close(getattr(tstate, f), getattr(jstate, f), name=f"{f} hour {h}")
    assert float(tstate.swe.max()) > 1.0


# ----------------------------------------------------------------------
# interception and cracking
# ----------------------------------------------------------------------

def test_interception_matches_jax():
    """canopy_water_management, plant_cover, storage_capacity and the
    HYDRALL variant on seeded maps: rel 1e-12."""
    rng = np.random.default_rng(5)
    shape = (30, 30)
    stored, rain, evap, lai = (rng.uniform(0.0, 2.5, shape), rng.uniform(0.0, 15.0, shape),
                               rng.uniform(0.0, 0.6, shape), rng.uniform(0.0, 6.0, shape))
    (js, ts), (jr, tr), (je, te), (jl, tl) = map(pair, (stored, rain, evap, lai))
    j = Ji.canopy_water_management(js, jr, je, jl)
    t = Ti.canopy_water_management(ts, tr, te, tl)
    assert sorted(t) == sorted(j)
    for k in j:
        close(t[k], j[k], name=k)
    close(Ti.plant_cover(tl), Ji.plant_cover(jl))
    close(Ti.storage_capacity(tl), Ji.storage_capacity(jl))
    close(Ti.hydrall_interception(tl, ts, tr), Ji.hydrall_interception(jl, js, jr))


@pytest.mark.parametrize("fine", ["default", "map"])
def test_cracking_matches_jax(fine):
    """soil_cracking on a 12 x 12 valley with seeded saturation (dry to
    wet), rain and ponding, with the default fine fraction and a seeded
    map: sink and residual rel 1e-12, no flipped cracked cell."""
    jg, tg = build_grids(valley_dem(12), total_depth=0.8)
    rng = np.random.default_rng(6)
    se = np.where(np.asarray(jg.mask), rng.uniform(0.05, 1.0, jg.shape), 0.0)
    prec = rng.uniform(0.0, 12.0, jg.shape[1:])
    pond = rng.uniform(0.0, 4.0, jg.shape[1:])
    (jse, tse), (jpr, tpr), (jpo, tpo) = map(pair, (se, prec, pond))
    kw_j, kw_t = {}, {}
    if fine == "map":
        jf, tf = pair(rng.uniform(0.3, 0.8, jg.shape[1:]))
        kw_j, kw_t = dict(fine_fraction=jf), dict(fine_fraction=tf)
    js, jres = Jcr.soil_cracking(jg, J.SolverParameters(), jse, jpr, jpo, **kw_j)
    ts, tres = Tcr.soil_cracking(tg, T.SolverParameters(), tse, tpr, tpo, **kw_t)
    close(ts, js, name="sink")
    close(tres, jres, name="residual")
    assert float(ts.sum()) > 0.0
    assert flips(tres != tpr, np.asarray(jres) != prec) == 0


# ----------------------------------------------------------------------
# crop
# ----------------------------------------------------------------------

CROPS = {
    "default": {},
    "tree_deformed": dict(is_tree=True, root_shape_deformation=1.6,
                          water_surplus_resistant=True, root_depth_min=0.1),
}


def _crop_inputs(seed=8, n=10):
    jg, tg = build_grids(valley_dem(n), total_depth=0.8)
    rng = np.random.default_rng(seed)
    shape2d = jg.shape[1:]
    dd = rng.uniform(0.0, 3500.0, shape2d)
    dd[0, :3] = (0.5, 1.0, 1.5)                   # the root-length thresholds
    lai = rng.uniform(0.0, 5.0, shape2d)
    lai[1, :2] = (0.0, 5e-6)                      # below EPSILON
    se = np.where(np.asarray(jg.mask), rng.uniform(0.02, 1.0, jg.shape), 0.0)
    se[0] = np.where(np.asarray(jg.mask[0]), 1.0, 0.0)
    et0 = rng.uniform(0.0, 0.8, shape2d)
    surf = rng.uniform(0.0, 0.003, shape2d)
    return jg, tg, dd, lai, se, et0, surf


@pytest.mark.parametrize("crop", sorted(CROPS))
def test_crop_functions_match_jax(crop):
    """LAI and degree days, covered fraction, potential ET, root length,
    both root-atom shapes, the quadrature, thresholds and the evaporation
    layer weights: rel 1e-12."""
    jcrop, tcrop = Jc.CropParameters(**CROPS[crop]), Tc.CropParameters(**CROPS[crop])
    jg, tg, dd, lai, se, et0, _ = _crop_inputs()
    jp, tp = J.SolverParameters(), T.SolverParameters()
    (jdd, tdd), (jl, tl), (je, te) = map(pair, (dd, lai, et0))
    rng = np.random.default_rng(9)
    (jtn, ttn), (jtx, ttx) = map(pair, (rng.uniform(-5, 20, dd.shape),
                                        rng.uniform(10, 38, dd.shape)))
    close(Tc.degree_day_increase(tcrop, ttn, ttx), Jc.degree_day_increase(jcrop, jtn, jtx))
    close(Tc.lai_from_degree_days(tcrop, tdd), Jc.lai_from_degree_days(jcrop, jdd))
    close(Tc.covered_surface_fraction(tl), Jc.covered_surface_fraction(jl))
    close(Tc.potential_evaporation(te, tl), Jc.potential_evaporation(je, jl))
    close(Tc.potential_transpiration(te, tl, 1.2), Jc.potential_transpiration(je, jl, 1.2))
    jlen = Jc.root_length(jcrop, jdd, 0.8)
    tlen = Tc.root_length(tcrop, tdd, 0.8)
    close(tlen, jlen, name="root_length")
    for shape in ("cardioid", "cylindrical"):
        close(Tc.root_density_atoms(tcrop, tg, tlen, shape),
              Jc.root_density_atoms(jcrop, jg, jlen, shape), name=shape)
    close(Tc.root_density_profile(tcrop, tg, tlen, method="quadrature"),
          Jc.root_density_profile(jcrop, jg, jlen, method="quadrature"),
          name="quadrature")
    for a, b in zip(Tc.water_content_thresholds(tg, tp, 35.0),
                    Jc.water_content_thresholds(jg, jp, 35.0)):
        close(a, b)
    jc_, jlc, jlast = Jc.evaporation_layer_coefficients(jg)
    tc_, tlc, tlast = Tc.evaporation_layer_coefficients(tg)
    assert tlast == jlast
    np.testing.assert_array_equal(tc_, np.asarray(jc_))
    np.testing.assert_array_equal(tlc, np.asarray(jlc))
    with pytest.raises(ValueError):
        Tc.root_density_atoms(tcrop, tg, tlen, "conical")


@pytest.mark.parametrize("demand", [False, True])
def test_sinks_match_jax(demand):
    """transpiration_sink (with and without demand_mm), evaporation_sink
    and factor_of_safety (plain and increase_slope) on seeded water
    contents: rel 1e-12, float64 sinks."""
    jcrop, tcrop = Jc.CropParameters(), Tc.CropParameters()
    jg, tg, dd, lai, se, et0, surf = _crop_inputs(seed=11)
    jp, tp = J.SolverParameters(), T.SolverParameters()
    theta_np = np.where(np.asarray(jg.mask),
                        se * (0.41 - 0.04) + 0.04, 0.0)
    (jth, tth), (je, te), (jl, tl), (jdd, tdd), (js, ts) = map(
        pair, (theta_np, et0, lai, dd, surf))
    kw_j, kw_t = {}, {}
    if demand:
        jd, td = pair(np.random.default_rng(12).uniform(0.0, 0.5, dd.shape))
        kw_j, kw_t = dict(demand_mm=jd), dict(demand_mm=td)
    jsink, jact = Jc.transpiration_sink(jg, jp, jcrop, jth, je, jl, jdd, **kw_j)
    tsink, tact = Tc.transpiration_sink(tg, tp, tcrop, tth, te, tl, tdd, **kw_t)
    close(tsink, jsink, name="transpiration sink")
    close(tact, jact, name="transpiration")
    assert float(tact.max()) > 0.0
    jsink, jact = Jc.evaporation_sink(jg, jp, jth, js, je, jl)
    tsink, tact = Tc.evaporation_sink(tg, tp, tth, ts, te, tl)
    close(tsink, jsink, name="evaporation sink")
    close(tact, jact, name="evaporation")
    assert tsink.dtype == torch.float64
    slope, _ = slope_aspect(valley_dem(10), 10.0)
    rng = np.random.default_rng(13)
    h_np = np.asarray(jg.z) + np.where(np.asarray(jg.mask),
                                       rng.uniform(-3.0, 0.1, jg.shape), 0.0)
    (jh, th), (jse, tse), (jsl, tsl) = map(pair, (h_np, se, slope))
    for inc in (False, True):
        close(Tc.factor_of_safety(tg, tp, th, tse, tsl, increase_slope=inc),
              Jc.factor_of_safety(jg, jp, jh, jse, jsl, increase_slope=inc),
              name=f"fos increase_slope={inc}")

"""The port's station interpolation (``physics/interpolation.py``) and meteo
substrate (``core/meteo.py``) against the JAX package's.

Inputs: the station sets of tests/test_interpolation.py (25 stations on a
slope with a perfect lapse rate; the thermal-inversion valley; the 30
stations with a broken sensor) plus seeded sets: a 5 x 5 lattice with tied
distances, and a set with NODATA readings and an ``active`` mask. Both
packages get the same numpy arrays; the port runs on the CPU.

Tolerances: maps and regression outputs within rel 1e-12 of JAX's, with an
absolute floor of 1e-12 x the map's max |value| (a map that crosses zero
has no relative error there); the thermal-inversion fit
``regression_orography_t``, ``check_fast_value_hourly``,
``ClimateParameters`` and the station series bit-equal (pure Python and
numpy in both); the spatial-QC masks equal.
"""

import dataclasses
import datetime

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from criteria3d_tpu.core import meteo as JM
from criteria3d_tpu.physics import interpolation as JI
from criteria3d_tpu_torch.core import meteo as TM
from criteria3d_tpu_torch.physics import interpolation as TI

torch.set_num_threads(1)

NODATA = -9999.0


def grid_coords(n=20, cell=100.0):
    """tests/test_interpolation.py's coordinate maps, as numpy."""
    rows, cols = np.mgrid[0:n, 0:n]
    return (cols * cell).astype(np.float64), ((n - 1 - rows) * cell).astype(np.float64)


def station_set(name):
    """(x, y, z, value, active) numpy arrays of a named station set."""
    if name == "slope25":       # test_detrended_idw_recovers_lapse_rate
        rng = np.random.RandomState(1)
        sx, sy = rng.uniform(0, 1900, 25), rng.uniform(0, 1900, 25)
        sz = rng.uniform(0, 1000, 25)
        return sx, sy, sz, 22.0 - 0.0065 * sz, None
    if name == "inversion20":   # test_detrended_idw_with_inversion_lapse
        rng = np.random.default_rng(11)
        sx, sy = rng.uniform(0.0, 1500.0, 20), rng.uniform(0.0, 1500.0, 20)
        sz = 100.0 + 1100.0 * sx / 1500.0
        sv = np.where(sz <= 400.0, 1.0 + 0.01 * sz,
                      1.0 + 0.01 * 400.0 - 0.0065 * (sz - 400.0))
        return sx, sy, sz, sv, None
    if name == "outlier30":     # test_spatial_quality_control_flags_outlier
        rng = np.random.RandomState(3)
        sx, sy = rng.uniform(0, 20000, 30), rng.uniform(0, 20000, 30)
        sz = rng.uniform(0, 500, 30)
        sv = 20.0 - 0.0065 * sz + rng.normal(0, 0.3, 30)
        sv[7] = 45.0
        return sx * 0.1, sy * 0.1, sz, sv, None
    if name == "lattice25":     # tied distances everywhere
        rng = np.random.default_rng(5)
        r, c = np.divmod(np.arange(25), 5)
        sx, sy = 100.0 + 400.0 * c, 150.0 + 400.0 * r
        sz = rng.uniform(50.0, 900.0, 25)
        sv = 12.0 - 0.006 * sz + rng.normal(0.0, 0.4, 25)
        sv[12] += 9.0
        return sx, sy, sz, sv, None
    if name == "gaps25":        # NODATA readings and an active mask
        rng = np.random.default_rng(9)
        sx, sy = rng.uniform(0, 1900, 25), rng.uniform(0, 1900, 25)
        sz = rng.uniform(0, 800, 25)
        sv = 8.0 - 0.005 * sz + rng.normal(0.0, 0.2, 25)
        sv[[2, 9, 17]] = NODATA
        active = np.ones(25, bool)
        active[[5, 20]] = False
        return sx, sy, sz, sv, active
    raise KeyError(name)


SETS = ("slope25", "inversion20", "outlier30", "lattice25", "gaps25")


def close(t, j, rel=1e-12):
    """The port's tensor (or number) against the JAX value."""
    a = np.asarray(j, dtype=np.float64)
    b = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t, dtype=np.float64)
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=rel, atol=rel * max(float(np.abs(a).max()), 1e-300))


def grid_z(n=20):
    return np.linspace(0, 1500, n)[None, :].repeat(n, 0)


@pytest.mark.parametrize("name", SETS)
def test_simple_regression_matches_jax(name):
    """(slope, intercept, r2) rel 1e-12, with and without the NODATA /
    active masking; 0-d float64 tensors on the CPU."""
    sx, sy, sz, sv, active = station_set(name)
    j = JI.simple_regression(jnp.asarray(sv), jnp.asarray(sz),
                             None if active is None else jnp.asarray(active))
    t = TI.simple_regression(sv, sz, active)
    for a, b in zip(j, t):
        assert b.ndim == 0 and b.dtype == torch.float64 and b.device.type == "cpu"
        close(b, a)


def _clean_case():
    rng = np.random.default_rng(7)
    z = rng.uniform(100.0, 1500.0, 25)
    return z, 22.0 - 0.0065 * z + rng.normal(0.0, 0.1, 25)


def _inversion_case():
    rng = np.random.default_rng(3)
    z_low = rng.uniform(50.0, 400.0, 12)
    z_high = rng.uniform(450.0, 1600.0, 12)
    t_low = 2.0 + 0.008 * z_low + rng.normal(0.0, 0.15, 12)
    t_high = 5.2 + 0.008 * 400.0 - 0.0065 * (z_high - 400.0) \
        + rng.normal(0.0, 0.15, 12) - 3.2
    return np.concatenate([z_low, z_high]), np.concatenate([t_low, t_high])


# tests/test_interpolation.py's three lapse cases
LAPSE_INPUTS = {
    "clean": _clean_case,
    "inversion": _inversion_case,
    "few": lambda: (np.asarray([100.0, 300.0, 700.0]), np.asarray([10.0, 9.0, 7.0])),
}


@pytest.mark.parametrize("case", list(LAPSE_INPUTS) + list(SETS))
def test_regression_orography_t_bit_equal(case):
    """The thermal-inversion fit gives JAX's OrographyLapse field for field
    (host numpy in both), and orography_trend gives JAX's values: bit-equal
    on numpy heights, rel 1e-12 on tensors (jnp in JAX)."""
    if case in LAPSE_INPUTS:
        z, v = LAPSE_INPUTS[case]()
    else:
        _, _, z, v, _ = station_set(case)
    zz = np.linspace(-50.0, 1800.0, 37)
    for clim in (-0.006, 0.0):
        jl = JI.regression_orography_t(z, v, climate_lapse_rate=clim)
        tl = TI.regression_orography_t(z, v, climate_lapse_rate=clim)
        assert dataclasses.asdict(tl) == dataclasses.asdict(jl)
        np.testing.assert_array_equal(TI.orography_trend(tl, zz),
                                      JI.orography_trend(jl, zz))
        close(TI.orography_trend(tl, torch.from_numpy(zz)),
              JI.orography_trend(jl, jnp.asarray(zz)))
    for lapse in (TI.OrographyLapse(), TI.OrographyLapse(valid=True, slope=-0.005)):
        jl = JI.OrographyLapse(**dataclasses.asdict(lapse))
        close(TI.orography_trend(lapse, torch.from_numpy(zz)),
              JI.orography_trend(jl, jnp.asarray(zz)))


@pytest.mark.parametrize("name", SETS)
def test_idw_map_matches_jax(name):
    """The station-by-station IDW map rel 1e-12 (the JAX scan adds in the
    same station order), with the active mask; float64 on the CPU."""
    sx, sy, _, sv, active = station_set(name)
    gx, gy = grid_coords()
    j = JI.idw_map(jnp.asarray(sx), jnp.asarray(sy), jnp.asarray(sv),
                   jnp.asarray(gx), jnp.asarray(gy),
                   active=None if active is None else jnp.asarray(active))
    t = TI.idw_map(sx, sy, sv, torch.from_numpy(gx), torch.from_numpy(gy),
                   active=active)
    assert t.dtype == torch.float64 and t.shape == (20, 20)
    close(t, j)


KINDS = ("temperature", "temperature_lapse", "generic_proxy", "precipitation",
         "precipitation_zero", "rh", "non_negative")


@pytest.mark.parametrize("name", SETS)
@pytest.mark.parametrize("kind", KINDS)
def test_detrended_idw_matches_jax(name, kind):
    """detrended_idw for every variable kind (the inversion lapse, an
    extra proxy, the precipitation threshold and all-zero shortcut, the RH
    clamp, the non-negative floor): the map rel 1e-12 and the elevation
    ProxyResult rel 1e-12 (significance equal)."""
    sx, sy, sz, sv, active = station_set(name)
    gx, gy = grid_coords()
    gz = grid_z()
    kw = {}
    j_kind = t_kind = None
    if kind.startswith("temperature"):
        j_kind, t_kind = JI.VariableKind.TEMPERATURE, TI.VariableKind.TEMPERATURE
        if kind == "temperature_lapse":
            lapse = JI.regression_orography_t(np.where(sv != NODATA, sz, NODATA), sv,
                                              climate_lapse_rate=-0.006)
            kw = dict(elevation_lapse=lapse)
    elif kind == "generic_proxy":
        j_kind, t_kind = JI.VariableKind.GENERIC, TI.VariableKind.GENERIC
        rng = np.random.default_rng(2)
        kw = dict(extra_station_proxies=(sy * 0.01 + rng.normal(0, 1, sy.shape),),
                  extra_grid_proxies=(gy * 0.01,))
    elif kind.startswith("precipitation"):
        j_kind, t_kind = JI.VariableKind.PRECIPITATION, TI.VariableKind.PRECIPITATION
        sv = np.where(sv != NODATA, np.abs(sv - np.median(sv)) * 0.5, NODATA)
        if kind == "precipitation_zero":
            sv = np.where(sv != NODATA, 0.0, NODATA)
    elif kind == "rh":
        j_kind, t_kind = JI.VariableKind.RELATIVE_HUMIDITY, TI.VariableKind.RELATIVE_HUMIDITY
        sv = np.where(sv != NODATA, 80.0 + 2.0 * sv, NODATA)
    else:
        j_kind, t_kind = JI.VariableKind.NON_NEGATIVE, TI.VariableKind.NON_NEGATIVE
        sv = np.where(sv != NODATA, sv - 8.0, NODATA)
    jm, jp = JI.detrended_idw(
        jnp.asarray(sx), jnp.asarray(sy), jnp.asarray(sz), jnp.asarray(sv),
        jnp.asarray(gx), jnp.asarray(gy), jnp.asarray(gz), kind=j_kind,
        active=None if active is None else jnp.asarray(active),
        **{k: (tuple(jnp.asarray(a) for a in v) if k.startswith("extra") else v)
           for k, v in kw.items()})
    if "elevation_lapse" in kw:
        kw["elevation_lapse"] = TI.OrographyLapse(**dataclasses.asdict(kw["elevation_lapse"]))
    if "extra_grid_proxies" in kw:
        kw["extra_grid_proxies"] = tuple(torch.from_numpy(a) for a in kw["extra_grid_proxies"])
    tm, tp = TI.detrended_idw(sx, sy, sz, sv, torch.from_numpy(gx),
                              torch.from_numpy(gy), torch.from_numpy(gz),
                              kind=t_kind, active=active, **kw)
    assert tm.dtype == torch.float64 and tm.device.type == "cpu"
    close(tm, jm)
    for f in ("slope", "intercept", "r2"):
        close(getattr(tp, f), getattr(jp, f))
    assert bool(tp.significant) == bool(jp.significant)


@pytest.mark.parametrize("name", SETS)
@pytest.mark.parametrize("modified", [False, True])
def test_shepard_idw_map_matches_jax(name, modified):
    """Shepard IDW batched over cells against JAX's per-cell vmap, classic
    and modified, rel 1e-12; on the lattice every cell sees tied distances,
    and the stable sort keeps JAX's top_k order. A small chunk size runs
    the batching over several chunks."""
    sx, sy, _, sv, active = station_set(name)
    gx, gy = grid_coords(12, 150.0)
    j = JI.shepard_idw_map(jnp.asarray(sx), jnp.asarray(sy), jnp.asarray(sv),
                           jnp.asarray(gx), jnp.asarray(gy), modified=modified,
                           active=None if active is None else jnp.asarray(active))
    chunk = TI._SHEPARD_CHUNK
    try:
        TI._SHEPARD_CHUNK = 50
        t = TI.shepard_idw_map(sx, sy, sv, torch.from_numpy(gx),
                               torch.from_numpy(gy), modified=modified,
                               active=active)
    finally:
        TI._SHEPARD_CHUNK = chunk
    close(t, j)


def test_quality_range_check_matches_jax():
    v = np.array([20.0, -80.0, 1.0, NODATA, 60.0, 60.5])
    jv, jok = JI.quality_range_check(jnp.asarray(v), -60.0, 60.0)
    tv, tok = TI.quality_range_check(v, -60.0, 60.0)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))


@pytest.mark.parametrize("name", SETS)
@pytest.mark.parametrize("kind", ["TEMPERATURE", "RELATIVE_HUMIDITY",
                                  "PRECIPITATION", "GENERIC"])
def test_spatial_quality_control_masks_equal(name, kind):
    """The leave-one-out spatial QC gives JAX's accepted mask for every
    variable kind; on the lattice the 10 nearest neighbours tie, and the
    stable argsort picks JAX's. The broken sensors are turned away."""
    sx, sy, sz, sv, _ = station_set(name)
    if kind == "PRECIPITATION":
        sv = np.where(sv != NODATA, np.abs(sv - np.median(sv)), NODATA)
    elif kind == "RELATIVE_HUMIDITY":
        sv = np.where(sv != NODATA, 60.0 + 1.5 * sv, NODATA)
    j = np.asarray(JI.spatial_quality_control(
        jnp.asarray(sx), jnp.asarray(sy), jnp.asarray(sz), jnp.asarray(sv),
        kind=getattr(JI.VariableKind, kind)))
    t = TI.spatial_quality_control(sx, sy, sz, sv, kind=getattr(TI.VariableKind, kind))
    assert t.dtype == torch.bool and t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy(), j)
    if kind == "TEMPERATURE" and name in ("outlier30", "lattice25"):
        assert not t[7 if name == "outlier30" else 12]


CLIMATE = dict(
    tmin=[-1.0, 0.0, 3.0, 7.0, 11.0, 15.0, 17.0, 17.0, 13.0, 9.0, 4.0, 0.0],
    tmax=[6.0, 9.0, 14.0, 18.0, 23.0, 27.0, 30.0, 30.0, 25.0, 19.0, 12.0, 7.0],
    tdmin=[-4.0] * 12, tdmax=[5.0] * 12,
    tmin_lapserate=[-0.004 - 0.0001 * m for m in range(12)],
    tmax_lapserate=[-0.0065] * 12,
    tdmin_lapserate=[-0.002] * 12, tdmax_lapserate=[-0.003] * 12)


@pytest.mark.parametrize("partial", [False, True])
def test_climate_parameters_bit_equal(partial):
    """ClimateParameters.from_ini_dict, lapse_rate for every variable,
    month, mid-month side and hour, and climate_var at several heights:
    bit-equal (a partial [climate] group leaves NODATA rates)."""
    ini = dict(CLIMATE)
    if partial:
        del ini["tmax_lapserate"], ini["tdmin"]
    jc = JM.ClimateParameters.from_ini_dict(ini)
    tc = TM.ClimateParameters.from_ini_dict(ini)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    names = ("AIR_TEMPERATURE", "DAILY_TMIN", "DAILY_TMAX", "DAILY_TAVG",
             "AIR_DEW_TEMPERATURE", "PRECIPITATION", "DAILY_RHMIN", "DAILY_RHMAX")
    for name in names:
        jv, tv = getattr(JM.MeteoVariable, name), getattr(TM.MeteoVariable, name)
        for month in range(1, 13):
            for day in (1, 14, 15, 28):
                for hour in (0, 6, 14, 23):
                    assert tc.lapse_rate(tv, month, day, hour) == \
                        jc.lapse_rate(jv, month, day, hour)
            for height in (NODATA, 0.0, 300.0, 1250.5):
                assert tc.climate_var(tv, month, height) == \
                    jc.climate_var(jv, month, height)


def test_check_fast_value_hourly_bit_equal():
    """The climate-based hourly gate accepts and refuses exactly what
    JAX's does, for every model variable, month, height and a sweep of
    values including NODATA, with and without climate normals."""
    jc = JM.ClimateParameters.from_ini_dict(CLIMATE)
    tc = TM.ClimateParameters.from_ini_dict(CLIMATE)
    values = [NODATA, -80.0, -59.5, -30.0, 0.0, 25.0, 49.9, 55.0, 59.0, 71.0, 120.0]
    for var in TM.MeteoVariable:
        jv = JM.MeteoVariable(var.value)
        for month in (1, 3, 7, 12):
            for height in (0.0, 300.0, 2300.0):
                for v in values:
                    for clim in ((jc, tc), (None, None)):
                        assert TM.check_fast_value_hourly(var, clim[1], v, month, height) \
                            == JM.check_fast_value_hourly(jv, clim[0], v, month, height)


def test_meteo_catalogue_and_station_equal():
    """The variable catalogue, DB ids and quality ranges are JAX's; a
    station's hourly / daily values, span and monthly aggregates are
    bit-equal."""
    assert [v.value for v in TM.MeteoVariable] == [v.value for v in JM.MeteoVariable]
    assert {k.value: v for k, v in TM.HOURLY_DB_IDS.items()} == \
        {k.value: v for k, v in JM.HOURLY_DB_IDS.items()}
    assert {k.value: v for k, v in TM.DAILY_DB_IDS.items()} == \
        {k.value: v for k, v in JM.DAILY_DB_IDS.items()}
    assert {k.value: (r.vmin, r.vmax) for k, r in TM.QUALITY_RANGES.items()} == \
        {k.value: (r.vmin, r.vmax) for k, r in JM.QUALITY_RANGES.items()}
    for i in (101, 105, 151, 172, 999):
        t, j = TM.variable_from_db_id(i), JM.variable_from_db_id(i)
        assert (t and t.value) == (j and j.value)
    rng = np.random.default_rng(4)
    hourly = rng.normal(5.0, 3.0, 60)
    hourly[[3, 17]] = np.nan
    daily = rng.uniform(0.0, 12.0, 75)
    daily[[10, 40]] = NODATA
    t0 = datetime.datetime(2023, 1, 30, 0)
    d0 = datetime.date(2023, 1, 20)
    sts = []
    for M in (JM, TM):
        st = M.MeteoStation(id="A", name="a", latitude=44.5, longitude=11.3,
                            utm_x=1.0, utm_y=2.0, altitude=100.0)
        st.set_hourly(M.MeteoVariable.AIR_TEMPERATURE, t0, hourly)
        st.daily_d0 = d0
        st.daily[M.MeteoVariable.DAILY_PREC] = daily
        st.daily[M.MeteoVariable.DAILY_TMAX] = daily + 3.0
        assert st.compute_monthly_aggregate(M.MeteoVariable.DAILY_PREC, 50.0)
        assert st.compute_monthly_aggregate(M.MeteoVariable.DAILY_TMAX, 50.0)
        sts.append(st)
    js, ts = sts
    assert ts.hourly_span == js.hourly_span and ts.monthly_m0 == js.monthly_m0
    for h in range(-2, 63):
        when = t0 + datetime.timedelta(hours=h)
        assert ts.hourly_value(TM.MeteoVariable.AIR_TEMPERATURE, when) == \
            js.hourly_value(JM.MeteoVariable.AIR_TEMPERATURE, when)
    for d in range(-1, 77):
        day = d0 + datetime.timedelta(days=d)
        assert ts.daily_value(TM.MeteoVariable.DAILY_PREC, day) == \
            js.daily_value(JM.MeteoVariable.DAILY_PREC, day)
    for name in ("MONTHLY_PREC", "MONTHLY_TMAX"):
        np.testing.assert_array_equal(ts.monthly[getattr(TM.MeteoVariable, name)],
                                      js.monthly[getattr(JM.MeteoVariable, name)])
        for month in range(1, 5):
            assert ts.monthly_value(getattr(TM.MeteoVariable, name), 2023, month) == \
                js.monthly_value(getattr(JM.MeteoVariable, name), 2023, month)
    with pytest.raises(ValueError):
        ts.set_hourly(TM.MeteoVariable.PRECIPITATION, t0 + datetime.timedelta(hours=1),
                      hourly)

"""The port's water-table subsystem (physics/watertable.py and the
project's ``watertable_*`` methods) against the JAX package, on
tests/test_rothc_watertable.py's inputs: the weighted climatic water
balance, the per-well fit and depth, the well CSV imports and the project
subsystem (import, fit against the nearest station, the daily depth map).

The module is host numpy in both packages; the project's ET0 is the daily
Hargreaves of each package's physics/meteo.py (float64 tensors in the
port). Tolerances: the CSV imports equal (wells, depths, wrong-line
counts); weighted CWB, fitted intercept and slope, R2, depths and the map
rel 1e-12; the fitted window equal.
"""

import datetime

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from criteria3d_tpu.core.meteo import MeteoStation as JStation
from criteria3d_tpu.core.meteo import MeteoVariable as JMV
from criteria3d_tpu.io.config import ProjectConfig as JConfig
from criteria3d_tpu.io.esri import RasterHeader as JHeader
from criteria3d_tpu.physics import watertable as JW
from criteria3d_tpu.physics.meteo import et0_hargreaves_daily
from criteria3d_tpu.project import Criteria3DProject as JProject
from criteria3d_tpu_torch.core.meteo import MeteoStation as TStation
from criteria3d_tpu_torch.core.meteo import MeteoVariable as TMV
from criteria3d_tpu_torch.io.config import ProjectConfig as TConfig
from criteria3d_tpu_torch.io.esri import RasterHeader as THeader
from criteria3d_tpu_torch.physics import watertable as TW
from criteria3d_tpu_torch.project import Criteria3DProject as TProject

torch.set_num_threads(1)


def well_series():
    """tests/test_rothc_watertable.py's synthetic well: 1200 days of gamma
    rain and a seasonal ET0, observed every 30 days from day 750."""
    rng = np.random.RandomState(0)
    n = 1200
    prec = rng.gamma(0.6, 5.0, n)
    et0 = 2.0 + 1.5 * np.sin(np.arange(n) / 365.0 * 2 * np.pi)
    return prec, et0


@pytest.mark.parametrize("nr_days", [90, 180, 365])
def test_weighted_cwb_matches_jax(nr_days):
    prec, et0 = well_series()
    for index in (40, 100, 400, 1100):
        for avg in (0.0, -0.8):
            assert TW.weighted_cwb(prec, et0, index, nr_days, avg) == \
                JW.weighted_cwb(prec, et0, index, nr_days, avg)


def test_fit_and_depth_match_jax():
    prec, et0 = well_series()
    truth = JW.WaterTableModel(h0=150.0, alpha=-1.2, nr_days=180)
    truth.avg_daily_cwb = float(np.mean(prec - et0))
    obs_idx = np.arange(750, 1150, 30)
    obs = np.array([truth.depth(prec, et0, i) for i in obs_idx])
    for step in (10, 5):
        jm, tm = JW.WaterTableModel(), TW.WaterTableModel()
        assert tm.fit(prec, et0, obs_idx, obs, step_days=step) == \
            jm.fit(prec, et0, obs_idx, obs, step_days=step)
        assert tm.nr_days == jm.nr_days
        for k in ("h0", "alpha", "r2", "avg_daily_cwb"):
            assert getattr(tm, k) == pytest.approx(getattr(jm, k), rel=1e-12), k
        for i in (800, 1100, 1199, 20):
            assert tm.depth(prec, et0, i) == pytest.approx(jm.depth(prec, et0, i),
                                                           rel=1e-12)
    assert TW.WaterTableModel().depth(prec, et0, 900) == \
        JW.WaterTableModel().depth(prec, et0, 900)


def _write_csvs(tmp_path):
    loc = tmp_path / "wells.csv"
    loc.write_text("ID,utmX,utmY\n"
                   "W1,680000,4950000\n"
                   '"W2", 681000, 4951000\n'
                   "W1,682000,4952000\n"
                   "W3,not_a_number,4953000\n")
    dep = tmp_path / "depths.csv"
    dep.write_text("ID,date,depth\n"
                   "W1,2020-03-01,120\n"
                   "W1,2020-04-01,140\n"
                   "W2,2020-03-01,90\n"
                   "W9,2020-03-01,100\n"
                   "W1,2020-05-01,9999\n"
                   "W1,bad-date,100\n")
    loc2 = tmp_path / "wells2.csv"
    loc2.write_text("ID,lat,lon\nA,44.8,11.6\n")
    return loc, dep, loc2


def test_well_csv_import_matches_jax(tmp_path):
    """The location and depth CSVs with the reference's wrong-line
    accounting, both header variants."""
    loc, dep, loc2 = _write_csvs(tmp_path)
    jw, jwrong = JW.load_well_locations_csv(str(loc), utm_zone=32)
    tw, twrong = TW.load_well_locations_csv(str(loc), utm_zone=32)
    assert twrong == jwrong == 2
    assert [vars(w) for w in tw] == [vars(w) for w in jw]
    assert TW.load_well_depths_csv(str(dep), tw) == \
        JW.load_well_depths_csv(str(dep), jw) == 3
    assert [w.depths for w in tw] == [w.depths for w in jw]
    (jw2, j2), (tw2, t2) = (JW.load_well_locations_csv(str(loc2), utm_zone=32),
                            TW.load_well_locations_csv(str(loc2), utm_zone=32))
    assert t2 == j2 == 0 and [vars(w) for w in tw2] == [vars(w) for w in jw2]


def _project_inputs(tmp_path):
    """tests/test_rothc_watertable.py's project subsystem: 900 days of a
    station's daily Tmin / Tmax / precipitation, a well whose depth follows
    h0 + alpha CWB(180 days), an 8 x 8 DEM."""
    rng = np.random.default_rng(7)
    n = 900
    d0 = datetime.date(2018, 1, 1)
    doy = np.array([(d0 + datetime.timedelta(days=int(i))).timetuple().tm_yday
                    for i in range(n)])
    tmin = 5.0 + 8.0 * np.sin(2 * np.pi * (doy - 120) / 365) + rng.normal(0, 1.5, n)
    tmax = tmin + 8.0 + rng.normal(0, 1.0, n)
    prec = np.where(rng.random(n) < 0.3, rng.gamma(2.0, 4.0, n), 0.0)
    et0 = np.asarray(et0_hargreaves_daily(0.17, 44.8, doy, tmax, tmin))
    truth = JW.WaterTableModel(h0=150.0, alpha=-1.2, nr_days=180,
                               avg_daily_cwb=float(np.mean(prec - et0)))
    obs_dates, obs_depths = [], []
    for i in range(750, 900, 15):
        x = JW.weighted_cwb(prec, et0, i, 180, truth.avg_daily_cwb)
        obs_dates.append(d0 + datetime.timedelta(days=i))
        obs_depths.append(truth.h0 + truth.alpha * x)
    loc = tmp_path / "wells_p.csv"
    loc.write_text("ID,utmX,utmY\nW1,680600,4950600\nW2,680590,4950580\n")
    dep = tmp_path / "depths_p.csv"
    dep.write_text("ID,date,depth\n" + "\n".join(
        f"{w},{d},{v + (3.0 if w == 'W2' else 0.0):.1f}"
        for w in ("W1", "W2") for d, v in zip(obs_dates, obs_depths)))
    return d0, dict(tmin=tmin, tmax=tmax, prec=prec), loc, dep, obs_dates


def _project(pkg, d0, series, hdr_kw):
    """An 8 x 8 project of either package with the one station."""
    station, mv, config, header, project = pkg
    st = station(id="S1", name="S1", latitude=44.8, longitude=11.6,
                 utm_x=680500.0, utm_y=4950500.0, altitude=10.0)
    st.daily_d0 = d0
    st.daily = {mv.DAILY_TMIN: series["tmin"], mv.DAILY_TMAX: series["tmax"],
                mv.DAILY_PREC: series["prec"]}
    hdr = header(**hdr_kw)
    dem = np.full((8, 8), 10.0)
    dem[0, 0] = -9999.0
    prj = project(config=config(utm_zone=32), dem=dem, header=hdr)
    prj.warnings = []
    prj.stations = [st]
    gx = hdr.xllcorner + (np.arange(8) + 0.5) * 10.0
    gy = hdr.yllcorner + (8 - 0.5 - np.arange(8)) * 10.0
    return prj, (np.broadcast_to(gx[None], (8, 8)).copy(),
                 np.broadcast_to(gy[:, None], (8, 8)).copy())


def test_project_watertable_matches_jax(tmp_path):
    """watertable_import_location / import_depths / compute /
    depth_map on both packages: the fitted wells (nearest station, window,
    intercept, slope, R2) and the depth map of the last observation day,
    with a nodata cell."""
    d0, series, loc, dep, obs_dates = _project_inputs(tmp_path)
    hdr_kw = dict(nrows=8, ncols=8, xllcorner=680560.0, yllcorner=4950560.0,
                  cellsize=10.0, nodata=-9999.0)
    jprj, (gx, gy) = _project((JStation, JMV, JConfig, JHeader, JProject),
                              d0, series, hdr_kw)
    tprj, _ = _project((TStation, TMV, TConfig, THeader, TProject), d0, series, hdr_kw)
    jprj._grid_xy = (jnp.asarray(gx), jnp.asarray(gy))
    tprj._grid_xy = (torch.from_numpy(gx), torch.from_numpy(gy))
    assert tprj.watertable_depth_map(obs_dates[-1]) is None
    assert tprj.watertable_import_location(str(loc)) == \
        jprj.watertable_import_location(str(loc)) == 0
    assert tprj.watertable_import_depths(str(dep)) == \
        jprj.watertable_import_depths(str(dep)) == 0
    jfits, tfits = jprj.watertable_compute(), tprj.watertable_compute()
    assert len(tfits) == len(jfits) == 2
    for (jw, jm, js), (tw, tm, ts) in zip(jfits, tfits):
        assert tw.id == jw.id and ts.id == js.id and tm.nr_days == jm.nr_days
        for k in ("h0", "alpha", "r2", "avg_daily_cwb"):
            assert getattr(tm, k) == pytest.approx(getattr(jm, k), rel=1e-12), k
        assert tm.r2 > 0.95
    assert tprj.warnings == jprj.warnings
    for day in (obs_dates[-1], obs_dates[3]):
        jmap, tmap = jprj.watertable_depth_map(day), tprj.watertable_depth_map(day)
        assert tmap.shape == (8, 8) and tmap[0, 0] == jmap[0, 0] == -9999.0
        np.testing.assert_allclose(tmap, jmap, rtol=1e-12)

"""The port's project IO against the JAX package's: geo conversions,
rasters (ESRI float, ASCII, ENVI) and resampling, the project and
parameters ini, the soil / crop / land-unit / meteo-points databases, the
meteo-points DB handler, and the output maps, points and rasters.

The files are the synthetic project of ``problems.write_project`` (8 x 8,
six stations) and rasters and CSVs written here from seeded numpy; both
packages read the same files. Tolerances: everything read from a file
equal (bit for bit: numpy and sqlite3 in both); written files
byte-identical; ``synthesize_hourly_from_daily`` and the output maps rel
1e-12 (the maps are float64 tensor math in the port, XLA in JAX);
output-point rows rel 1e-12.
"""

import dataclasses
import datetime
import os
import shutil
import sqlite3

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import criteria3d_tpu as J
from criteria3d_tpu import outputs as JO
from criteria3d_tpu.core import geo as JG
from criteria3d_tpu.core.meteo import MeteoVariable as JMV
from criteria3d_tpu.io import config as JC
from criteria3d_tpu.io import database as JD
from criteria3d_tpu.io import esri as JE
from criteria3d_tpu.io import meteopoints as JP
from criteria3d_tpu.solver.step import initialize_balance as j_initialize_balance
import criteria3d_tpu_torch as T
from criteria3d_tpu_torch import outputs as TO
from criteria3d_tpu_torch import problems
from criteria3d_tpu_torch.core import geo as TG
from criteria3d_tpu_torch.core.meteo import MeteoVariable as TMV
from criteria3d_tpu_torch.io import config as TC
from criteria3d_tpu_torch.io import database as TD
from criteria3d_tpu_torch.io import esri as TE
from criteria3d_tpu_torch.io import meteopoints as TP
from criteria3d_tpu_torch.solver.step import initialize_balance as t_initialize_balance
from tests.test_catchment3d import valley_dem
from tests.test_torch_core import build_grids

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def project_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("prj")
    ini = problems.write_project(str(d), n=8, seed=3, n_stations=6)
    return d, ini


def as_dicts(objs):
    return [dataclasses.asdict(o) for o in objs]


def test_geo_bit_equal():
    """utm_to_latlon, latlon_to_utm (zone given and derived, both
    hemispheres) and latlon_maps give JAX's arrays bit for bit."""
    rng = np.random.default_rng(0)
    e, nn = rng.uniform(3e5, 7e5, 50), rng.uniform(4.5e6, 5.2e6, 50)
    for ref_lat in (44.5, -33.0):
        for a, b in zip(TG.utm_to_latlon(32, ref_lat, e, nn),
                        JG.utm_to_latlon(32, ref_lat, e, nn)):
            np.testing.assert_array_equal(a, b)
    lat, lon = rng.uniform(-60, 70, 50), rng.uniform(-10, 20, 50)
    for zone in (32, None):
        t, j = TG.latlon_to_utm(lat, lon, zone), JG.latlon_to_utm(lat, lon, zone)
        np.testing.assert_array_equal(t[0], j[0])
        np.testing.assert_array_equal(t[1], j[1])
        assert t[2] == j[2]
    hdr = TE.RasterHeader(nrows=7, ncols=9, xllcorner=682000.0, yllcorner=4929000.0,
                          cellsize=25.0)
    jhdr = JE.RasterHeader(**dataclasses.asdict(hdr))
    for a, b in zip(TG.latlon_maps(hdr, 32), JG.latlon_maps(jhdr, 32)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fmt", ["flt", "asc", "img"])
def test_rasters_round_trip_byte_identical(tmp_path, fmt):
    """write_flt / write_asc / write_envi write JAX's bytes, and read_raster
    (by extension and extensionless) reads JAX's arrays and headers back;
    an extensionless .asc path fails in both, as the JAX reader opens the
    path without its extension."""
    rng = np.random.default_rng(1)
    data = np.round(rng.uniform(-50.0, 900.0, (11, 13)), 3)
    data[2, 3] = -9999.0
    hdr = TE.RasterHeader(nrows=11, ncols=13, xllcorner=682001.5,
                          yllcorner=4929003.25, cellsize=4.0)
    jhdr = JE.RasterHeader(**dataclasses.asdict(hdr))
    write = {"flt": (TE.write_flt, JE.write_flt), "asc": (TE.write_asc, JE.write_asc),
             "img": (TE.write_envi, JE.write_envi)}[fmt]
    exts = {"flt": (".flt", ".hdr"), "asc": (".asc",), "img": (".img", ".hdr")}[fmt]
    paths = {}
    for side, fn, h in (("t", write[0], hdr), ("j", write[1], jhdr)):
        os.makedirs(tmp_path / side)
        paths[side] = str(tmp_path / side / f"map.{fmt}")
        fn(paths[side], data, h)
    for ext in exts:
        assert (tmp_path / "t" / f"map{ext}").read_bytes() == \
            (tmp_path / "j" / f"map{ext}").read_bytes(), ext
    for path in (paths["t"], paths["t"][:-4]):
        if fmt == "asc" and path == paths["t"][:-4]:
            # both open the path without its extension (esri.py:205-206)
            for read in (TE.read_raster, JE.read_raster):
                with pytest.raises(FileNotFoundError):
                    read(path)
            continue
        td, th = TE.read_raster(path)
        jd, jh = JE.read_raster(path)
        np.testing.assert_array_equal(td, jd)
        assert td.dtype == jd.dtype and dataclasses.asdict(th) == dataclasses.asdict(jh)


@pytest.mark.parametrize("method", ["prevailing", "average", "median", "center"])
@pytest.mark.parametrize("factor", [2.5, 0.5])
def test_resample_grid_equal(method, factor):
    """resample_grid onto a coarser (2.5x) and a finer grid, every method,
    with NODATA holes and a valid-ratio threshold: JAX's array exactly."""
    rng = np.random.default_rng(2)
    values = rng.integers(1, 5, (24, 30)).astype(np.float64)
    if method in ("average", "median"):
        values = values * 1.7 + rng.uniform(0, 1, values.shape)
    values[5:9, 4:12] = -9999.0
    hdr = TE.RasterHeader(nrows=24, ncols=30, xllcorner=1000.0, yllcorner=2000.0,
                          cellsize=10.0)
    new = TE.RasterHeader(nrows=int(24 / factor), ncols=int(30 / factor),
                          xllcorner=1003.0, yllcorner=1998.0, cellsize=10.0 * factor)
    for thr in (0.0, 0.4):
        t = TE.resample_grid(values, hdr, new, method, thr)
        j = JE.resample_grid(values, JE.RasterHeader(**dataclasses.asdict(hdr)),
                             JE.RasterHeader(**dataclasses.asdict(new)), method, thr)
        np.testing.assert_array_equal(t, j)


def test_tif_and_fields_db_are_refused(tmp_path):
    """GeoTIFF is ported (tests/test_torch_geotiff.py holds it against
    JAX): read_raster reads a .tif, with or without its extension, as JAX's
    does, and refuses a missing or broken one with JAX's error. The VINE3D
    fields DB is ported (tests/test_torch_vine3d.py reads one): a missing
    DB is refused with the same sqlite error as JAX's reader."""
    from criteria3d_tpu.io.geotiff import write_geotiff
    data = np.arange(20.0).reshape(4, 5)
    write_geotiff(str(tmp_path / "x.tif"), data,
                  JE.RasterHeader(nrows=4, ncols=5, xllcorner=10.0, yllcorner=20.0,
                                  cellsize=2.0))
    for path in (str(tmp_path / "x.tif"), str(tmp_path / "x")):
        (tv, th), (jv, jh) = TE.read_raster(path), JE.read_raster(path)
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(tv, data)
        assert dataclasses.asdict(th) == dataclasses.asdict(jh)
    (tmp_path / "y.tif").write_bytes(b"")
    for E in (TE, JE):
        with pytest.raises(FileNotFoundError):
            E.read_raster(str(tmp_path / "z.tif"))
        with pytest.raises(ValueError, match="not a TIFF"):
            E.read_raster(str(tmp_path / "y"))
    missing = str(tmp_path / "fields.db")
    with pytest.raises(sqlite3.OperationalError) as jerr:
        JD.read_fields_db(missing)
    with pytest.raises(sqlite3.OperationalError) as terr:
        TD.read_fields_db(missing)
    assert str(terr.value) == str(jerr.value)


def test_project_ini_equal(project_dir):
    """load_project_ini (with its parameters.ini) gives JAX's ProjectConfig
    field for field; solver_parameters gives JAX's numbers, with heat on
    too (vapor and advection)."""
    _, ini = project_dir
    t, j = TC.load_project_ini(ini), JC.load_project_ini(ini)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.use_thermal_inversion and len(t.climate_monthly["tmin"]) == 12
    for heat in (False, True):
        t.compute_heat = j.compute_heat = heat
        tp, jp = t.solver_parameters(4.0), j.solver_parameters(4.0)
        for f in dataclasses.fields(tp):
            if f.name not in ("dtype", "sweep_dtype", "wrc_model", "mean_type"):
                assert getattr(tp, f.name) == getattr(jp, f.name), f.name
        assert tp.heat_vapor == tp.heat_advection == heat
    tparams = TC.load_parameters_ini(os.path.join(os.path.dirname(ini), "parameters.ini"))
    jparams = JC.load_parameters_ini(os.path.join(os.path.dirname(ini), "parameters.ini"))
    assert dataclasses.asdict(tparams) == dataclasses.asdict(jparams)


@pytest.mark.parametrize("fitting", [True, False])
def test_soil_db_equal(project_dir, fitting):
    """read_soil_db with and without van Genuchten fitting (scipy, lazily
    imported): every profile and horizon field equal, and the fitted
    horizon differs from its texture-class defaults."""
    d, _ = project_dir
    path = str(d / "DATA" / "soil.db")
    t, j = TD.read_soil_db(path, fitting=fitting), JD.read_soil_db(path, fitting=fitting)
    assert list(t) == list(j) == ["CL", "SL"]
    for k in t:
        assert (t[k].id_soil, t[k].code, t[k].name, t[k].total_depth) == \
            (j[k].id_soil, j[k].code, j[k].name, j[k].total_depth)
        assert as_dicts(t[k].horizons) == as_dicts(j[k].horizons)
        for depth in (0.0, 0.15, 0.3, 0.7, 0.9):
            th, jh = t[k].horizon_at(depth), j[k].horizon_at(depth)
            assert (th and dataclasses.asdict(th)) == (jh and dataclasses.asdict(jh))
    fitted = t["CL"].horizons[1]
    assert (fitted.vg_alpha != t["CL"].horizons[0].vg_alpha) == fitting
    for sand, silt, clay in [(30, 35, 35), (65, 25, 10), (90, 5, 5), (10, 85, 5),
                             (None, 40, 20), (50, 50, 50)]:
        assert TD.usda_texture_class(sand, silt, clay) == \
            JD.usda_texture_class(sand, silt, clay)
    data = np.array([[1.0, 0.43], [10.0, 0.38], [33.0, 0.33], [100.0, 0.27],
                     [1500.0, 0.15]])
    assert TD.fit_van_genuchten(data, 0.45) == JD.fit_van_genuchten(data, 0.45)


def test_crop_and_land_units_equal(project_dir):
    """read_crop_db, CropRecord.to_parameters (the port's CropParameters)
    and read_land_units equal JAX's."""
    d, _ = project_dir
    path = str(d / "DATA" / "crop.db")
    t, j = TD.read_crop_db(path), JD.read_crop_db(path)
    assert {k: dataclasses.asdict(v) for k, v in t.items()} == \
        {k: dataclasses.asdict(v) for k, v in j.items()}
    assert dataclasses.asdict(t["GRASS"].to_parameters()) == \
        dataclasses.asdict(j["GRASS"].to_parameters())
    assert isinstance(t["GRASS"].to_parameters(), T.model.crop_mod.CropParameters)
    units = TD.read_land_units(path)
    assert units == JD.read_land_units(path)
    assert {u["landuse"] for u in units} == {"HERBACEOUS", "URBAN", "ROAD", "FOREST"}


def test_meteo_points_equal(project_dir, tmp_path):
    """read_meteo_points_db and MeteoPointsDB.read_stations (hourly series,
    clipped windows, daily series) equal JAX's; write_daily, point_ids and
    the schema agree."""
    d, _ = project_dir
    src = str(d / "DATA" / "meteo.db")
    assert as_dicts(TD.read_meteo_points_db(src)) == as_dicts(JD.read_meteo_points_db(src))
    paths = {}
    for side, M, daily_prec in (("t", TP, TMV.DAILY_PREC), ("j", JP, JMV.DAILY_PREC)):
        paths[side] = str(tmp_path / f"{side}.db")
        shutil.copy(src, paths[side])
        with M.MeteoPointsDB(paths[side]) as db:
            n = db.write_daily("S00", daily_prec, datetime.date(2023, 3, 1),
                               [1.0, -9999.0, 2.5, float("nan"), 0.0])
            assert n == 3
    for window in ((None, None), (datetime.datetime(2023, 3, 21, 5),
                                  datetime.datetime(2023, 3, 21, 9))):
        got = []
        for side, M in (("t", TP), ("j", JP)):
            with M.MeteoPointsDB(paths[side]) as db:
                got.append(db.read_stations(load_hourly=True, load_daily=True,
                                            t0=window[0], t1=window[1]))
                assert db.point_ids() == [f"S{i:02d}" for i in range(6)]
        ts, js = got
        assert len(ts) == len(js) == 6
        for a, b in zip(ts, js):
            assert (a.id, a.name, a.latitude, a.longitude, a.utm_x, a.utm_y,
                    a.altitude, a.is_active, a.hourly_t0, a.daily_d0) == \
                (b.id, b.name, b.latitude, b.longitude, b.utm_x, b.utm_y,
                 b.altitude, b.is_active, b.hourly_t0, b.daily_d0)
            assert {k.value: v.tolist() for k, v in a.hourly.items()} == \
                {k.value: v.tolist() for k, v in b.hourly.items()}
            assert {k.value: v.tolist() for k, v in a.daily.items()} == \
                {k.value: v.tolist() for k, v in b.daily.items()}


def test_import_hourly_csv_equal(tmp_path):
    """import_hourly_csv into a new DB: the same import statistics (wrong
    dates, out-of-order rows, out-of-range and unparsable values, missing
    fields) and the same rows read back."""
    csv_path = tmp_path / "ST1_H.csv"
    lines = ["DATE,HOUR,TAVG,PREC,RHAVG,RAD,W_SCAL_INT"]
    rng = np.random.default_rng(6)
    for h in range(30):
        day = datetime.date(2023, 3, 20) + datetime.timedelta(days=h // 24)
        lines.append(f"{day.isoformat()},{h % 24},{rng.normal(5, 3):.2f},"
                     f"{max(rng.normal(0.2, 1), 0):.1f},{rng.uniform(40, 99):.0f},"
                     f"{rng.uniform(0, 700):.0f},{rng.uniform(0, 6):.1f}")
    lines += ["2023-03-21,3,1,2,3,4,5", "2023-13-01,1,1,1,1,1,1", "2023-03-21,25,1,1,1,1,1",
              "2023-03-21,7,99.0,x,120,,2", "2023-03-21,8,4.0"]
    csv_path.write_text("\n".join(lines) + "\n")
    out = []
    for side, M in (("t", TP), ("j", JP)):
        with M.MeteoPointsDB(str(tmp_path / f"{side}.db"), create=True) as db:
            db.write_point_properties(id_point="ST1", latitude=44.5, longitude=11.3,
                                      altitude=80.0)
            stats = db.import_hourly_csv(str(csv_path))
            rows = db.db.execute("SELECT * FROM ST1_H ORDER BY 1, 2").fetchall()
            props = db.db.execute("SELECT * FROM point_properties").fetchall()
            st = db.read_stations()[0]
        out.append((stats, rows, props, {k.value: v.tolist() for k, v in st.hourly.items()}))
    assert out[0] == out[1]
    assert out[0][0]["wrong_datetime"] >= 3 and out[0][0]["wrong_data"] >= 2


def test_synthesize_hourly_from_daily_matches_jax():
    """The daily -> hourly synthesis (the port's sun position on the CPU):
    temperature, RH and precipitation bit-equal, radiation rel 1e-12."""
    tmin, tmax, prec = [1.0, 3.5, -2.0], [9.0, 12.5, 4.0], [0.0, 12.0, 2.4]
    d0 = datetime.date(2023, 3, 20)
    t = TP.synthesize_hourly_from_daily(tmin, tmax, prec, d0, latitude=44.5)
    j = JP.synthesize_hourly_from_daily(tmin, tmax, prec, d0, latitude=44.5)
    assert t["t0"] == j["t0"]
    tv = {k.value: v for k, v in t.items() if k != "t0"}
    jv = {k.value: v for k, v in j.items() if k != "t0"}
    assert set(tv) == set(jv)
    for k in ("airTemperature", "airRelHumidity", "precipitation"):
        np.testing.assert_array_equal(tv[k], jv[k])
    np.testing.assert_allclose(tv["globalIrradiance"], jv["globalIrradiance"],
                               rtol=1e-12, atol=1e-12 * jv["globalIrradiance"].max())
    assert jv["globalIrradiance"].max() > 100.0


@pytest.fixture(scope="module")
def water_pair():
    """A valley grid and a wet initial state in both packages (port on
    the CPU), with ponding on the surface."""
    dem = valley_dem(8)
    jg, tg = build_grids(dem)
    jp, tp = J.SolverParameters(), T.SolverParameters()
    js = j_initialize_balance(jg, jp, J.WaterState.initialize(jg, jp, matric_potential=-0.8))
    ts = t_initialize_balance(tg, tp, T.WaterState.initialize(tg, tp, matric_potential=-0.8,
                                                              device="cpu"))
    rng = np.random.default_rng(8)
    dh = rng.uniform(-0.3, 0.3, jg.shape) * np.asarray(jg.mask)
    dh[0] = np.abs(dh[0]) * 0.01
    js = dataclasses.replace(js, h=js.h + jnp.asarray(dh))
    ts = dataclasses.replace(ts, h=ts.h + torch.from_numpy(dh))
    from criteria3d_tpu.solver import water as JW
    from criteria3d_tpu_torch.solver import water as TW
    js = dataclasses.replace(js, se=JW.compute_se(jg, jp, js.h))
    ts = dataclasses.replace(ts, se=TW.compute_se(tg, tp, ts.h))
    return jg, jp, js, tg, tp, ts


@pytest.mark.parametrize("var", [v.name for v in TO.OutputVariable])
def test_compute_variable_map_matches_jax(water_pair, var):
    """Every output variable at every layer, rel 1e-12 (absolute floor
    1e-12 x the map's max |value|; the factor of safety also with a slope
    map), NODATA outside the layer's mask, a float64 map on the CPU."""
    jg, jp, js, tg, tp, ts = water_pair
    tv, jv = getattr(TO.OutputVariable, var), getattr(JO.OutputVariable, var)
    heat_t = 283.0 + np.random.default_rng(1).uniform(0, 5, jg.shape)
    jheat = type("Heat", (), {"t": jnp.asarray(heat_t)})
    theat = type("Heat", (), {"t": torch.from_numpy(heat_t)})
    slopes = [None]
    if var == "FACTOR_OF_SAFETY":
        slopes.append(np.random.default_rng(2).uniform(0.0, 40.0, jg.shape[1:]))
    for slope in slopes:
        for layer in range(jg.n_layers):
            j = JO.compute_variable_map(jg, jp, js, jv, layer, heat=jheat,
                                        slope_deg=None if slope is None else jnp.asarray(slope))
            t = TO.compute_variable_map(tg, tp, ts, tv, layer, heat=theat,
                                        slope_deg=None if slope is None else torch.from_numpy(slope))
            assert t.dtype == torch.float64 and t.device.type == "cpu"
            a, b = np.asarray(j, dtype=np.float64), t.numpy()
            np.testing.assert_array_equal(np.isnan(b), np.isnan(a))
            fin = ~np.isnan(a)
            if fin.any():       # the factor of safety is NaN on layer 0
                np.testing.assert_allclose(b[fin], a[fin], rtol=1e-12,
                                           atol=1e-12 * float(np.abs(a[fin]).max()))
    with pytest.raises(ValueError):
        TO.compute_variable_map(tg, tp, ts, TO.OutputVariable.SOIL_TEMPERATURE, 1)


def test_output_points_and_rasters_equal(water_pair, tmp_path):
    """OutputPoints.write_hour rows (two hours, extra maps as tensors in the
    port and arrays in JAX) rel 1e-12 with the same tables and columns;
    OutputPoints.from_csv equal; write_output_rasters writes JAX's files
    byte for byte (one float32 ulp allowed) with one host copy per map."""
    from criteria3d_tpu_torch.device import host_read
    jg, jp, js, tg, tp, ts = water_pair
    variables = {"VOLUMETRIC_WATER_CONTENT": [10, 30], "WATER_MATRIC_POTENTIAL": [10],
                 "FACTOR_OF_SAFETY": [20], "SURFACE_WATER_LEVEL": [0]}
    tvars = {getattr(TO.OutputVariable, k): v for k, v in variables.items()}
    jvars = {getattr(JO.OutputVariable, k): v for k, v in variables.items()}
    extra = np.random.default_rng(3).normal(5.0, 2.0, jg.shape[1:])
    tpts = TO.OutputPoints(ids=["A", "B", "7"], rows=[2, 5, 0], cols=[3, 4, 7])
    jpts = JO.OutputPoints(ids=["A", "B", "7"], rows=[2, 5, 0], cols=[3, 4, 7])
    for time_str in ("2023-03-21 06:00:00", "2023-03-21 07:00:00"):
        host_read.count = 0
        tpts.write_hour(str(tmp_path / "t.db"), time_str, tg, tp, ts, tvars,
                        extra_maps={"airTemperature": torch.from_numpy(extra)})
        assert host_read.count == 1
        jpts.write_hour(str(tmp_path / "j.db"), time_str, jg, jp, js, jvars,
                        extra_maps={"airTemperature": extra})
    dbs = {}
    for side in ("t", "j"):
        con = sqlite3.connect(str(tmp_path / f"{side}.db"))
        tables = sorted(r[0] for r in con.execute(
            "SELECT name FROM sqlite_master WHERE type='table'"))
        dbs[side] = {tab: ([c[1] for c in con.execute(f'PRAGMA table_info("{tab}")')],
                           con.execute(f'SELECT * FROM "{tab}" ORDER BY time').fetchall())
                     for tab in tables}
        con.close()
    assert list(dbs["t"]) == list(dbs["j"]) == ["point_7", "point_A", "point_B"]
    for tab, (cols, rows) in dbs["t"].items():
        jcols, jrows = dbs["j"][tab]
        assert cols == jcols and len(rows) == len(jrows) == 2
        for r, jr in zip(rows, jrows):
            assert r[0] == jr[0]
            np.testing.assert_allclose(r[1:], jr[1:], rtol=1e-12)
    csv_path = tmp_path / "pts.csv"
    csv_path.write_text("id,utm_x,utm_y\nA,15,65\nB,45.5,12\nC,-5,10\nD,79.9,0.1\n")
    tfc = TO.OutputPoints.from_csv(str(csv_path), tg)
    assert dataclasses.asdict(tfc) == dataclasses.asdict(JO.OutputPoints.from_csv(str(csv_path), jg))
    host_read.count = 0
    tfiles = TO.write_output_rasters(str(tmp_path / "tr"), "20230321_H06", tg, tp, ts, tvars)
    assert host_read.count == len(tfiles) == 5
    jfiles = JO.write_output_rasters(str(tmp_path / "jr"), "20230321_H06", jg, jp, js, jvars)
    assert [os.path.basename(f) for f in tfiles] == [os.path.basename(f) for f in jfiles]
    for tf, jf in zip(tfiles, jfiles):
        assert open(tf[:-4] + ".hdr").read() == open(jf[:-4] + ".hdr").read()
        a, b = np.fromfile(jf, "<f4"), np.fromfile(tf, "<f4")
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        fin = ~np.isnan(a)
        assert np.all(np.abs(a[fin].view(np.int32) - b[fin].view(np.int32)) <= 1), tf

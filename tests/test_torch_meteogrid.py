"""The port's meteo grid DB (``io/meteogrid.py``) and the project's meteo
grid methods against the JAX package's.

The inputs are those of tests/test_meteogrid.py (its XML, its daily,
cell-property and hourly tables, its 20 x 20 aggregation raster), a seeded
raster with nodata holes for every aggregation method, and
``problems.write_project(n=16)`` with ``problems.write_meteo_grid`` (a UTM
grid of 20 m cells, 5 x 5 = 25 cells) loaded and run by both packages.
Tolerances: everything read from a file, the aggregates and the virtual
stations equal (numpy and sqlite3 in both); the forcing maps rel 1e-12
(the interpolation is float64 tensor math in the port, XLA in JAX); f64
heads within 1e-9 m and MBRs within 1e-9 over 2 hours; the exported grid
tables with the same rows, the exported values (averages of the forcing
maps) rel 1e-12.
"""

import dataclasses
import datetime
import shutil
import sqlite3

import numpy as np
import pytest
import torch

from criteria3d_tpu.io import meteogrid as JM
from criteria3d_tpu.io.esri import RasterHeader as JHeader
from criteria3d_tpu.project import Criteria3DProject as JProject
from criteria3d_tpu_torch import problems
from criteria3d_tpu_torch.device import host_read
from criteria3d_tpu_torch.io import meteogrid as TM
from criteria3d_tpu_torch.io.esri import RasterHeader as THeader
from criteria3d_tpu_torch.project import Criteria3DProject as TProject
from tests.test_meteogrid import XML
from tests.test_torch_project import close

torch.set_num_threads(1)

DAY = datetime.datetime(*problems.PROJECT_DATE)
METHODS = ("average", "median", "min", "max", "sum", "std", "95perc")


@pytest.fixture()
def xml(tmp_path):
    p = tmp_path / "grid.xml"
    p.write_text(XML)
    return str(p)


def test_parse_xml_equal(xml, tmp_path):
    t, j = TM.parse_grid_xml(xml), JM.parse_grid_xml(xml)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.nr_rows == 3 and t.daily_varcodes["tmin"] == "DAILY_TMIN"
    # the project loader's example: a UTM grid with its hourly tables
    ini = problems.write_project(str(tmp_path / "p"), n=8, seed=2, n_stations=3)
    x, _ = problems.write_meteo_grid(str(tmp_path / "p"), ini, cell=12.0,
                                     margin=8.0, seed=2)
    t, j = TM.parse_grid_xml(x), JM.parse_grid_xml(x)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.is_utm and t.nr_rows == t.nr_cols == 4 and t.hourly_postfix == "_H"


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_daily_tables_read_alike(xml, tmp_path, writer):
    """Daily tables written by one package read equal by both."""
    mods = {"port": TM, "jax": JM}
    s = mods[writer].parse_grid_xml(xml)
    mods[writer].MeteoGridDb(str(tmp_path / "grid.db"), s).write_daily(
        "00042", ["2023-01-01", "2023-01-02", "2023-01-03"],
        {"tmin": [1.0, -2.0, 0.5], "tmax": [8.0, 4.0, 7.0]})
    codes = np.array([["00042", "00042"], ["missing", "00042"]], dtype=object)
    out = []
    for m in (TM, JM):
        db = m.MeteoGridDb(str(tmp_path / "grid.db"), m.parse_grid_xml(xml))
        dates, tmin = db.read_daily("00042", "tmin")
        out.append((dates, tmin, db.read_daily_map(codes, "tmax", "2023-01-02"),
                    db.read_daily("nocell", "tmin")[0]))
    (td, tt, tm, tn), (jd, jt, jm, jn) = out
    assert td == jd == ["2023-01-01", "2023-01-02", "2023-01-03"] and tn == jn == []
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tm, jm)
    assert tm[0, 0] == 4.0 and tm[1, 0] == -9999.0


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cells_and_hourly_tables_read_alike(xml, tmp_path, writer):
    """CellsProperties and long hourly tables written by one package: the
    cells, codes, series and hourly maps read equal by both; a map written
    through write_hourly_map (NODATA and inactive cells skipped)."""
    mods = {"port": TM, "jax": JM}
    m = mods[writer]
    db = m.MeteoGridDb(str(tmp_path / "grid.db"), m.parse_grid_xml(xml))
    cells = [m.GridCell(code="001", row=0, col=0, height=120.0),
             m.GridCell(code="002", row=2, col=3, height=340.0),
             m.GridCell(code="003", row=1, col=1, active=False)]
    db.write_cell_properties(cells)
    times = ["2023-06-01 00:00", "2023-06-01 01:00", "2023-06-01 02:00"]
    db.write_hourly("001", times, {101: [15.0, 14.5, 14.0], 102: [0.0, 1.2, 0.0]})
    grid_vals = np.full((3, 4), -9999.0)
    grid_vals[2, 3] = 7.5
    grid_vals[1, 1] = 3.0
    db.write_hourly_map(cells, 103, datetime.datetime(2023, 6, 1, 1), grid_vals)
    out = []
    for mod in (TM, JM):
        d = mod.MeteoGridDb(str(tmp_path / "grid.db"), mod.parse_grid_xml(xml))
        got = d.load_cell_properties()
        codes = d.cell_codes_2d(got)
        out.append(([dataclasses.asdict(c) for c in got], codes,
                    d.read_hourly("001", 101), d.read_hourly("009", 101),
                    d.read_hourly_map(codes, 102, "2023-06-01 01:00"),
                    d.read_hourly_map(codes, 103, datetime.datetime(2023, 6, 1, 1)),
                    mod.cell_center(d.structure, 2, 3)))
    t, j = out
    assert t[0] == j[0] and [c["code"] for c in t[0]] == ["001", "002", "003"]
    np.testing.assert_array_equal(t[1], j[1])
    assert t[2][0] == j[2][0] == times
    np.testing.assert_array_equal(t[2][1], j[2][1])
    assert t[3][0] == j[3][0] == []
    for k in (4, 5):
        np.testing.assert_array_equal(t[k], j[k])
    assert t[5][2, 3] == 7.5 and t[5][1, 1] == -9999.0
    assert t[6] == j[6]


def test_cells_outside_the_grid_refused(xml, tmp_path):
    db = TM.MeteoGridDb(str(tmp_path / "grid.db"), TM.parse_grid_xml(xml))
    db.write_cell_properties([TM.GridCell(code="X", row=3, col=0)])
    for m in (TM, JM):
        d = m.MeteoGridDb(str(tmp_path / "grid.db"), m.parse_grid_xml(xml))
        with pytest.raises(ValueError, match="outside"):
            d.load_cell_properties()
        with pytest.raises(sqlite3.OperationalError):
            m.MeteoGridDb(str(tmp_path / "none.db"), d.structure).load_cell_properties()


@pytest.mark.parametrize("method", METHODS)
def test_aggregate_raster_to_grid_equal(method):
    """Every aggregation method on a seeded 30 x 27 raster with nodata
    holes over a 4 x 3 grid (one cell under 10% coverage), and the
    quadrant raster of tests/test_meteogrid.py, equal in both packages."""
    rng = np.random.default_rng(7)
    vals = rng.normal(12.0, 3.0, (30, 27))
    vals[rng.random(vals.shape) < 0.2] = -9999.0
    vals[:8, :9] = -9999.0
    vals[3, 4] = 5.0
    hdr = dict(nrows=30, ncols=27, xllcorner=5.0, yllcorner=-3.0, cellsize=10.0,
               nodata=-9999.0)
    grids = [dict(nr_rows=4, nr_cols=3, ll_longitude=0.0, ll_latitude=0.0,
                  dx=90.0, dy=75.0, is_utm=True)]
    quad = np.zeros((20, 20))
    quad[10:, :10], quad[:10, 10:], quad[:10, :10] = 1.0, 2.0, 3.0
    qhdr = dict(nrows=20, ncols=20, xllcorner=0.0, yllcorner=0.0, cellsize=10.0,
                nodata=-9999.0)
    qgrid = dict(nr_rows=2, nr_cols=2, ll_longitude=0.0, ll_latitude=0.0,
                 dx=100.0, dy=100.0, is_utm=True)
    for v, h, g in ((vals, hdr, grids[0]), (quad, qhdr, qgrid)):
        t = TM.aggregate_raster_to_grid(v, THeader(**h), TM.MeteoGridStructure(**g),
                                        method=method)
        j = JM.aggregate_raster_to_grid(v, JHeader(**h), JM.MeteoGridStructure(**g),
                                        method=method)
        np.testing.assert_array_equal(t, j)
        assert (t != -9999.0).any()
    assert t[1, 0] == {"sum": 300.0, "std": 0.0}.get(method, 3.0)
    for m, header in ((TM, THeader), (JM, JHeader)):
        with pytest.raises(ValueError, match="unknown aggregation"):
            m.aggregate_raster_to_grid(quad, header(**qhdr),
                                       m.MeteoGridStructure(**qgrid), method="mode")


def station_key(st):
    return (st.id, st.name, st.latitude, st.longitude, st.utm_x, st.utm_y,
            st.altitude, st.hourly_t0,
            {k.name: v.tolist() for k, v in st.hourly.items()})


@pytest.mark.parametrize("utm", [True, False])
def test_stations_from_grid_equal(tmp_path, utm):
    """Active cells as virtual stations, in a UTM grid (with and without a
    zone) and a lat-lon grid (the zone from longitude): the same ids,
    coordinates, heights and densified hourly series (a gap stays NODATA)."""
    s = dict(nr_rows=2, nr_cols=3, is_utm=utm,
             ll_longitude=686000.0 if utm else 11.2,
             ll_latitude=4929000.0 if utm else 44.4,
             dx=500.0 if utm else 0.05, dy=500.0 if utm else 0.05)
    db_path = str(tmp_path / "grid.db")
    db = TM.MeteoGridDb(db_path, TM.MeteoGridStructure(**s))
    cells = [TM.GridCell(code=f"C{i}", row=i // 3, col=i % 3,
                         height=100.0 + 50 * i, active=i != 4) for i in range(6)]
    cells[1].height = -9999.0
    db.write_cell_properties(cells)
    t0 = datetime.datetime(2023, 3, 21, 6)
    rng = np.random.default_rng(1)
    for i, c in enumerate(cells):
        hours = [0, 1, 3] if i == 2 else [0, 1, 2, 3]
        times = [(t0 + datetime.timedelta(hours=h)).strftime("%Y-%m-%d %H:%M")
                 for h in hours]
        db.write_hourly(c.code, times, {101: rng.normal(5.0, 2.0, len(hours)),
                                        102: rng.random(len(hours))})
    for zone in ((32, None) if utm else (None,)):
        tdb = TM.MeteoGridDb(db_path, TM.MeteoGridStructure(**s))
        jdb = JM.MeteoGridDb(db_path, JM.MeteoGridStructure(**s))
        ts = TM.stations_from_grid(tdb, utm_zone=zone)
        js = JM.stations_from_grid(jdb, utm_zone=zone)
        assert [station_key(a) for a in ts] == [station_key(b) for b in js]
        assert len(ts) == 5 and ts[1].altitude == 0.0
        assert len(ts[2].hourly) == 2 and ts[2].hourly_value(
            next(iter(ts[2].hourly)), t0 + datetime.timedelta(hours=2)) == -9999.0


@pytest.fixture(scope="module")
def grid_project(tmp_path_factory):
    d = tmp_path_factory.mktemp("gridprj")
    ini = problems.write_project(str(d), n=16, seed=0, n_stations=6)
    xml, db = problems.write_meteo_grid(str(d), ini, cell=20.0, margin=20.0, seed=0)
    return ini, xml, db


def load_grid_both(grid_project, tmp_path):
    """Both packages load the project with the grid as its weather, each
    from its own copy of the grid DB (they write into it)."""
    ini, xml, db = grid_project
    out = []
    for name, cls in (("j", JProject), ("t", TProject)):
        copy = str(tmp_path / f"{name}_grid.db")
        shutil.copyfile(db, copy)
        prj = cls.load(ini, output_dir=str(tmp_path / name))
        prj.load_meteo_grid(xml, copy)
        prj.initialize(**({"device": "cpu"} if cls is TProject else {}))
        out.append(prj)
    return out


def test_write_meteo_grid_is_deterministic(grid_project, tmp_path):
    ini, xml, db = grid_project
    x2, db2 = problems.write_meteo_grid(str(tmp_path), ini, cell=20.0, margin=20.0,
                                       seed=0)
    assert open(x2, "rb").read() == open(xml, "rb").read()
    assert open(db2, "rb").read() == open(db, "rb").read()
    x3, db3 = problems.write_meteo_grid(str(tmp_path / "other"), ini, cell=20.0,
                                       margin=20.0, seed=1)
    assert open(db3, "rb").read() != open(db, "rb").read()


def dump_db(path) -> dict:
    con = sqlite3.connect(path)
    out = {t: con.execute(f'SELECT * FROM "{t}" ORDER BY 1, 2').fetchall()
           for (t,) in con.execute("SELECT name FROM sqlite_master WHERE type='table'")}
    con.close()
    return out


def test_grid_project_forcing_hours_and_export(grid_project, tmp_path):
    """The project's weather from the grid: 25 virtual stations equal in
    both; hourly forcing at 8 and 11 h rel 1e-12 (one host read an hour);
    run_period over 11-12 h in float64 with outputs: heads within 1e-9 m,
    MBRs within 1e-9; export_hourly_to_grid of the 12 h temperature map
    (a device map read in one counted copy): the same aggregate and the
    same grid tables; without a grid it raises in both."""
    jp, tp = load_grid_both(grid_project, tmp_path)
    assert len(tp.stations) == len(jp.stations) == 25
    assert [station_key(a) for a in tp.stations] == [station_key(b) for b in jp.stations]
    assert len(tp.meteo_grid_cells) == 25 and tp.warnings == jp.warnings
    for hour in (8, 11):
        when = DAY + datetime.timedelta(hours=hour)
        jf = jp.hourly_forcing(when)
        host_read.count = 0
        tf = tp.hourly_forcing(when)
        assert host_read.count == 1
        for f in ("air_temperature", "precipitation", "rel_humidity", "wind_speed"):
            close(getattr(tf, f), getattr(jf, f))
        assert tf.transmissivity == pytest.approx(float(jf.transmissivity), rel=1e-12)
    start = DAY + datetime.timedelta(hours=11)
    jlog, tlog = jp.run_period(start, 2), tp.run_period(start, 2)
    for a, b in zip(tlog, jlog):
        assert abs(a["mbr"] - b["mbr"]) < 1e-9 and abs(a["mbr"]) < 2e-3
    dh = float(np.abs(np.asarray(jp.model.water.h) - tp.model.water.h.numpy()).max())
    assert dh < 1e-9, dh
    when = start + datetime.timedelta(hours=1)
    jt = jp.run_hour(when, write_outputs=False)["forcing"].air_temperature
    tt = tp.run_hour(when, write_outputs=False)["forcing"].air_temperature
    close(tt, jt)
    mask = tp.grid.mask[0]
    code = 101
    host_read.count = 0
    ta = tp.export_hourly_to_grid(code, torch.where(mask, tt, -9999.0), when)
    assert host_read.count == 1
    ja = jp.export_hourly_to_grid(code, np.where(np.asarray(jp.grid.mask[0]),
                                                 np.asarray(jt), -9999.0), when)
    close(ta, ja)
    assert (ta != -9999.0).sum() >= 4
    # the same tables and rows; the exported values, averages of forcing
    # maps that agree to rel 1e-12, to rel 1e-12
    tables = [dump_db(p.meteo_grid.path) for p in (tp, jp)]
    assert tables[0].keys() == tables[1].keys()
    for name, rows in tables[0].items():
        jrows = tables[1][name]
        assert [r[:-1] for r in rows] == [r[:-1] for r in jrows], name
        np.testing.assert_allclose([r[-1] for r in rows], [r[-1] for r in jrows],
                                   rtol=1e-12, atol=0)
    rows = [r for r in tables[0]["002002_H"] if r[1] == code]
    assert len(rows) == 24 and when.strftime("%Y-%m-%d %H:%M") in [r[0] for r in rows]
    back = tp.meteo_grid.read_hourly_map(tp.meteo_grid.cell_codes_2d(), code, when)
    valid = ta != -9999.0
    np.testing.assert_allclose(back[valid], ta[valid], rtol=0, atol=1e-6)
    for prj in (TProject.load(grid_project[0]), JProject.load(grid_project[0])):
        with pytest.raises(ValueError, match="no meteo grid"):
            prj.export_hourly_to_grid(code, np.zeros((16, 16)), when)

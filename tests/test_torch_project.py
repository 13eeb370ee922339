"""The port's project (``criteria3d_tpu_torch.project.Criteria3DProject``)
against the JAX package's on one project on disk.

The project is ``problems.write_project(n=16, seed=0, n_stations=6)``: a
16 x 16 box of the synthetic catchment with two soils (one horizon's van
Genuchten curve fitted from lab data), land units with an URBAN strip, a
ROAD line and a FOREST patch, six stations of the cold day 2023-03-21 with
a thermal inversion before 9 h and a broken temperature at 8 h, three
output points and output maps at 10 and 30 cm. Both packages load the
same files; the port runs on the CPU.

Tolerances: the loaded project equal; the grid bit-equal or within rel
1e-14, the initial heads bit-equal and the balance sums rel 1e-13; the hourly forcing maps rel 1e-12 (absolute floor
1e-12 x the map's max |value|); float64 hours through ``run_period``: the
same dt_curr, heads within 1e-9 m, each hour's MBR within 1e-9, output
rasters byte-identical or one float32 ulp, output-point values rel 1e-9; a
``fast=True`` hour: heads within 1e-4 m and both |MBR| < 2e-3.
"""

import dataclasses
import datetime
import os
import sqlite3

import numpy as np
import pytest
import torch

from criteria3d_tpu.project import Criteria3DProject as JProject
from criteria3d_tpu_torch import convert, problems
from criteria3d_tpu_torch.device import host_read
from criteria3d_tpu_torch.project import Criteria3DProject as TProject
from tests.test_torch_core import assert_fields, grid_meta, to_arrays

torch.set_num_threads(1)

DAY = datetime.datetime(*problems.PROJECT_DATE)


@pytest.fixture(scope="module")
def ini(tmp_path_factory):
    d = tmp_path_factory.mktemp("project")
    return problems.write_project(str(d), n=16, seed=0, n_stations=6)


def load_both(ini, tmp_path, *, fast=False):
    """The same project loaded and initialised by both packages, each
    writing its outputs under its own directory."""
    jp = JProject.load(ini, output_dir=str(tmp_path / "j"))
    jp.initialize(fast=fast)
    tp = TProject.load(ini, output_dir=str(tmp_path / "t"))
    tp.initialize(fast=fast, device="cpu")
    return jp, tp


def close(t, j, rel=1e-12):
    a = np.asarray(j, dtype=np.float64)
    b = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t, dtype=np.float64)
    assert a.shape == b.shape
    np.testing.assert_allclose(b, a, rtol=rel, atol=rel * float(np.abs(a).max()))


def model_arrays(jm) -> dict:
    """A JAX model's fields as the arrays convert.model_from_arrays takes."""
    arrays = dict(grid=to_arrays(jm.grid), water=to_arrays(jm.water),
                  heat=None if jm.heat is None else to_arrays(jm.heat),
                  snow=None if jm.snow is None else to_arrays(jm.snow),
                  config=dataclasses.asdict(jm.config),
                  crop=None if jm.crop is None else dataclasses.asdict(jm.crop))
    for name in convert.MODEL_MAPS:
        v = getattr(jm, name)
        arrays[name] = None if v is None else np.asarray(v)
    for name in convert.MODEL_ACCUMULATORS:
        arrays[name] = np.asarray(getattr(jm, name))
    return arrays


def test_load_and_initialize_match_jax(ini, tmp_path):
    """load: DEM, header, soils, resampled soil and land-use maps, land
    units, crops, stations (hourly series), climate and output paths equal.
    initialize: the same grid (every field bit-equal or rel 1e-14), solver
    parameters, initial water state (heads bit-equal, the balance sums rel
    1e-13), slope / aspect, forest mask, output
    points and coordinate maps, all on the CPU (without ``device`` the
    project builds on the card: tests/test_torch_core.py)."""
    jp, tp = load_both(ini, tmp_path)
    assert tp.warnings == jp.warnings == []
    np.testing.assert_array_equal(tp.dem, jp.dem)
    assert dataclasses.asdict(tp.header) == dataclasses.asdict(jp.header)
    assert list(tp.soils) == list(jp.soils)
    for k in tp.soils:
        assert [dataclasses.asdict(h) for h in tp.soils[k].horizons] == \
            [dataclasses.asdict(h) for h in jp.soils[k].horizons]
    np.testing.assert_array_equal(tp.soil_id_map, jp.soil_id_map)
    np.testing.assert_array_equal(tp.land_unit_map, jp.land_unit_map)
    assert tp.land_units == jp.land_units
    assert {k: dataclasses.asdict(v) for k, v in tp.crops.items()} == \
        {k: dataclasses.asdict(v) for k, v in jp.crops.items()}
    assert dataclasses.asdict(tp.climate) == dataclasses.asdict(jp.climate)
    assert (tp.output_dir, tp.config.output_db_path) != (jp.output_dir, jp.config.output_db_path)
    assert len(tp.stations) == len(jp.stations) == 6
    for a, b in zip(tp.stations, jp.stations):
        assert (a.id, a.utm_x, a.utm_y, a.altitude, a.latitude, a.hourly_t0) == \
            (b.id, b.utm_x, b.utm_y, b.altitude, b.latitude, b.hourly_t0)
        assert {k.value: v.tolist() for k, v in a.hourly.items()} == \
            {k.value: v.tolist() for k, v in b.hourly.items()}

    assert_fields(jp.grid, tp.grid, rtol=1e-14)
    assert tp.grid.device.type == "cpu" and tp.device.type == "cpu"
    # the URBAN strip is an Urban boundary; the ROAD line has no subsurface
    assert bool((tp.grid.btype[1] == 5).any())
    assert bool((tp.grid.mask[0] & ~tp.grid.mask[1]).any())
    for f in dataclasses.fields(tp.params):
        if f.name not in ("dtype", "sweep_dtype", "wrc_model", "mean_type"):
            assert getattr(tp.params, f.name) == getattr(jp.params, f.name), f.name
    # heads bit-equal; the balance sums over the nodes add in another order
    assert_fields(jp.model.water, tp.model.water, exact=("h",), rtol=1e-13)
    for name in ("slope_deg", "aspect_deg", "forest_mask", "lai", "degree_days"):
        np.testing.assert_array_equal(getattr(tp.model, name).numpy(),
                                      np.asarray(getattr(jp.model, name)), err_msg=name)
    assert int(tp.model.forest_mask.sum()) > 0
    np.testing.assert_array_equal(tp.slope_deg, jp.slope_deg)
    assert dataclasses.asdict(tp.output_points) == dataclasses.asdict(jp.output_points)
    for a, b in zip(tp._grid_xy, jp._grid_xy):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert tp.output_variables().keys() and \
        [k.value for k in tp.output_variables()] == [k.value for k in jp.output_variables()]


def test_hourly_forcing_matches_jax(ini, tmp_path):
    """hourly_forcing at 6-9 h (the inversion, snow, rain on the pack, the
    broken reading at 8 h): temperature, precipitation, RH (through the dew
    point) and wind maps rel 1e-12 on the CPU, the transmissivity rel
    1e-12, spatial QC turning the broken reading away, one host read per
    hour (the stations' clear-sky potential)."""
    jp, tp = load_both(ini, tmp_path)
    for hour in (6, 7, 8, 9):
        when = DAY + datetime.timedelta(hours=hour)
        jf = jp.hourly_forcing(when)
        host_read.count = 0
        tf = tp.hourly_forcing(when)
        assert host_read.count == 1
        for f in ("air_temperature", "precipitation", "rel_humidity", "wind_speed"):
            t = getattr(tf, f)
            assert t.dtype == torch.float64 and t.device.type == "cpu"
            close(t, getattr(jf, f))
        assert tf.transmissivity == pytest.approx(float(jf.transmissivity), rel=1e-12)
        if hour >= 8:
            assert float(tf.precipitation.max()) > 0.0
    assert tp.qc_rejected >= 1
    assert tp._station_trans.keys() == jp._station_trans.keys()


def read_db(path):
    con = sqlite3.connect(path)
    tables = sorted(r[0] for r in con.execute(
        "SELECT name FROM sqlite_master WHERE type='table'"))
    out = {t: ([c[1] for c in con.execute(f'PRAGMA table_info("{t}")')],
               con.execute(f'SELECT * FROM "{t}" ORDER BY time').fetchall())
           for t in tables}
    con.close()
    return out


def test_run_period_f64_matches_jax(ini, tmp_path):
    """Three float64 hours (6-8 h) through run_period with outputs: the
    same dt_curr, heads within 1e-9 m, each hour's MBR within 1e-9; the
    same raster files, headers byte-identical and values within one
    float32 ulp; the same output-point tables with values rel 1e-9."""
    jp, tp = load_both(ini, tmp_path)
    start = DAY + datetime.timedelta(hours=6)
    jlog = jp.run_period(start, 3)
    tlog = tp.run_period(start, 3)
    assert [e["time"] for e in tlog] == [e["time"] for e in jlog]
    for a, b in zip(tlog, jlog):
        assert isinstance(a["mbr"], float)
        assert abs(a["mbr"] - b["mbr"]) < 1e-9, (a, b)
    assert float(tp.model.water.dt_curr) == float(jp.model.water.dt_curr)
    dh = float(np.abs(np.asarray(jp.model.water.h) - tp.model.water.h.numpy()).max())
    assert dh < 1e-9, dh
    # SWE is not held here: at 8 h the snow step's branches on the pack
    # (isothermal, internal energy at or next to 0) flip on rounding-level
    # differences of the state after 7 h; from the same state the step
    # agrees (test_jax_model_carried_into_the_project, PERF.md section 2)

    tdir = tmp_path / "t" / "rasters" / "20230321"
    jdir = tmp_path / "j" / "rasters" / "20230321"
    files = sorted(os.listdir(tdir))
    assert files == sorted(os.listdir(jdir)) and len(files) == 2 * 3 * 4
    for f in files:
        a, b = (jdir / f).read_bytes(), (tdir / f).read_bytes()
        if f.endswith(".hdr"):
            assert a == b, f
            continue
        ja, ta = np.frombuffer(a, "<f4"), np.frombuffer(b, "<f4")
        np.testing.assert_array_equal(np.isnan(ja), np.isnan(ta))
        fin = ~np.isnan(ja)
        assert np.all(np.abs(ja[fin].view(np.int32) - ta[fin].view(np.int32)) <= 1), f

    tdb, jdb = read_db(tp.config.output_db_path), read_db(jp.config.output_db_path)
    assert list(tdb) == list(jdb) == ["point_P1", "point_P2", "point_P3"]
    for table, (cols, rows) in tdb.items():
        jcols, jrows = jdb[table]
        assert cols == jcols and len(rows) == len(jrows) == 3
        for r, jr in zip(rows, jrows):
            assert r[0] == jr[0]
            np.testing.assert_allclose(r[1:], jr[1:], rtol=1e-9, atol=1e-12)


def test_fast_hour_within_f32_envelope(ini, tmp_path):
    """initialize(fast=True) selects the float32 CG-line path in both;
    one hour (6 h): heads within 1e-4 m, both |MBR| < 2e-3."""
    jp, tp = load_both(ini, tmp_path, fast=True)
    assert tp.params.sweep_dtype == torch.float32 and tp.params.inner_solver == "cg"
    assert tp.params.cg_precond == "line" and not tp.params.heat_frozen_props
    when = DAY + datetime.timedelta(hours=6)
    jo = jp.run_hour(when, write_outputs=False)
    to = tp.run_hour(when, write_outputs=False)
    dh = float(np.abs(np.asarray(jp.model.water.h) - tp.model.water.h.numpy()).max())
    assert dh < 1e-4, dh
    assert abs(float(to["mbr"])) < 2e-3 and abs(float(jo["mbr"])) < 2e-3


def test_jax_model_carried_into_the_project(ini, tmp_path):
    """A JAX project's model after hours 6-7, carried into the port's
    project by convert.project_model_from_arrays (with the stations'
    carried transmissivity), then hour 8 (rain on the pack, the broken
    reading) in both: the carried state equal, then the same dt_curr,
    heads within 1e-9 m, MBR within 1e-9 and SWE within 1e-9 mm. From the
    same state the snow step agrees; the free run departs in SWE at 8 h
    only through rounding-level differences of the state after 7 h
    (PERF.md section 2)."""
    jp, tp = load_both(ini, tmp_path)
    for hour in (6, 7):
        jp.run_hour(DAY + datetime.timedelta(hours=hour), write_outputs=False)
    convert.project_model_from_arrays(tp, model_arrays(jp.model), grid_meta(jp.model.grid),
                                      station_trans=jp._station_trans)
    assert tp.grid is tp.model.grid and tp.model.params is tp.params
    np.testing.assert_array_equal(tp.model.water.h.numpy(), np.asarray(jp.model.water.h))
    np.testing.assert_array_equal(tp.model.forest_mask.numpy(),
                                  np.asarray(jp.model.forest_mask))
    when = DAY + datetime.timedelta(hours=8)
    jo = jp.run_hour(when, write_outputs=False)
    to = tp.run_hour(when, write_outputs=False)
    close(to["forcing"].air_temperature, jo["forcing"].air_temperature)
    assert float(tp.model.water.dt_curr) == float(jp.model.water.dt_curr)
    dh = float(np.abs(np.asarray(jp.model.water.h) - tp.model.water.h.numpy()).max())
    assert dh < 1e-9, dh
    assert abs(float(to["mbr"]) - float(jo["mbr"])) < 1e-9
    swe = np.asarray(jp.model.snow.swe)
    assert swe.max() > 0.0
    assert float(np.abs(swe - tp.model.snow.swe.numpy()).max()) < 1e-9


def test_unported_project_parts_raise(ini, tmp_path):
    """The parts that raised until the meteo grid and the report were
    ported now run and agree with JAX: the meteo grid DB
    (problems.write_meteo_grid) as the weather source, with the same
    virtual stations and an export of a map into its tables; the HTML run
    report of an initialised project after an hour, with its text equal
    (footer masked) and its images equal as decoded pixels (at most 0.1%
    differing: the state maps agree to ~1e-11). The water-table subsystem
    (tests/test_torch_watertable.py holds it against JAX) behaves as JAX's
    on this project, whose stations carry no daily series: a missing well
    file raises FileNotFoundError, the fit finds no station and warns, and
    there is no depth map."""
    from tests.test_torch_cli import pixel_share, split_html
    xml, db = problems.write_meteo_grid(str(tmp_path / "g"), ini, cell=20.0,
                                        margin=0.0, seed=3)
    tp, jp = TProject.load(ini), JProject.load(ini)
    for prj in (tp, jp):
        prj.load_meteo_grid(xml, db, as_forcing=False)
    assert len(tp.meteo_grid_cells) == len(jp.meteo_grid_cells) == 9
    assert tp.stations and [s.id for s in tp.stations] == [s.id for s in jp.stations]
    agg = [prj.export_hourly_to_grid(101, prj.dem, DAY, method="max")
           for prj in (tp, jp)]
    np.testing.assert_array_equal(agg[0], agg[1])
    assert (agg[0] != -9999.0).all()
    jpr, tpr = load_both(ini, tmp_path)
    for prj in (jpr, tpr):
        prj.run_hour(DAY + datetime.timedelta(hours=10), write_outputs=False)
    reports = []
    for prj, name in ((jpr, "j.html"), (tpr, "t.html")):
        prj.write_report(str(tmp_path / "rep" / name),
                         log=[dict(time=str(DAY), mbr=1e-5),
                              dict(time=str(DAY + datetime.timedelta(hours=1)),
                                   mbr=-3e-5)])
        reports.append(split_html((tmp_path / "rep" / name).read_text()))
    (jt, ji), (tt, ti) = reports
    assert tt == jt and len(ti) == len(ji) == 5
    assert "total water content [m3]" in tt
    for a, b in zip(ti, ji):
        assert a == b or pixel_share(a, b, tmp_path) <= 1e-3
    for prj in (tp, jp):
        with pytest.raises(FileNotFoundError):
            prj.watertable_import_location(str(tmp_path / "w.csv"))
        assert prj.watertable_compute() == []
        assert prj.watertable_depth_map(DAY.date()) is None
    assert tp.warnings == jp.warnings
    with pytest.raises(RuntimeError):
        tp.run_hour(DAY)

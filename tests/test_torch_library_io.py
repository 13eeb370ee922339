"""The port's side library against the JAX package: core/watershed.py,
io/netcdf.py, io/shapefile.py, io/shape_utils.py, io/reproject.py,
io/import_xml.py, io/forecast_dataset.py, io/criteria_output.py and
io/utility_db.py, on the inputs of the JAX package's own tests
(test_watershed.py, test_netcdf.py, test_shapefile.py, test_reproject.py,
test_import_xml.py, test_forecast_dataset.py, test_criteria_output.py,
test_rothc_watertable.py).

Each module is host numpy, struct, sqlite3 and ElementTree in both
packages, the port's a copy. Tolerances: every file written (NetCDF-3,
.shp/.shx/.dbf, CSV, sqlite) byte-identical for the same arguments (no file
embeds a time or a package name); parsed tables, rasters, headers and
coordinates equal; scipy and h5py imported only inside the functions that
need them, and a missing one raises as in JAX.
"""

import dataclasses
import datetime as dt
import os
import sqlite3
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from criteria3d_tpu.core import watershed as JW
from criteria3d_tpu.io import criteria_output as JC
from criteria3d_tpu.io import forecast_dataset as JFD
from criteria3d_tpu.io import import_xml as JX
from criteria3d_tpu.io import netcdf as JN
from criteria3d_tpu.io import reproject as JR
from criteria3d_tpu.io import shape_utils as JSU
from criteria3d_tpu.io import shapefile as JS
from criteria3d_tpu.io import utility_db as JU
from criteria3d_tpu.io.esri import RasterHeader as JHeader
from criteria3d_tpu.physics.watertable import WaterTableModel as JWT
from criteria3d_tpu_torch.core import watershed as TW
from criteria3d_tpu_torch.io import criteria_output as TC
from criteria3d_tpu_torch.io import forecast_dataset as TFD
from criteria3d_tpu_torch.io import import_xml as TX
from criteria3d_tpu_torch.io import netcdf as TN
from criteria3d_tpu_torch.io import reproject as TR
from criteria3d_tpu_torch.io import shape_utils as TSU
from criteria3d_tpu_torch.io import shapefile as TS
from criteria3d_tpu_torch.io import utility_db as TU
from criteria3d_tpu_torch.io.esri import RasterHeader as THeader
from criteria3d_tpu_torch.physics.watertable import WaterTableModel as TWT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def same(a, b, path="value"):
    """Equal values: arrays by value and dtype, dataclasses and plain
    objects field by field (either package's class), containers item by
    item, floats exactly (NaN equal to NaN)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        if a.dtype.kind == "f":
            np.testing.assert_array_equal(a, b, err_msg=path)
        else:
            assert (a == b).all(), path
    elif dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and isinstance(b, float) and np.isnan(a):
        assert np.isnan(b), path
    elif hasattr(a, "__dict__") and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, path
        same({k: v for k, v in vars(a).items() if not k.startswith("_")},
             {k: v for k, v in vars(b).items() if not k.startswith("_")}, path)
    else:
        assert type(a) is type(b) and a == b, f"{path}: {a!r} != {b!r}"


def files_equal(dir_a, dir_b, names):
    for name in names:
        with open(os.path.join(dir_a, name), "rb") as f, \
                open(os.path.join(dir_b, name), "rb") as g:
            assert f.read() == g.read(), name


def both_dirs(tmp_path):
    a, b = tmp_path / "jax", tmp_path / "port"
    a.mkdir()
    b.mkdir()
    return a, b


# ---------------------------------------------------------------------------
# watershed (test_watershed.py's DEMs)
# ---------------------------------------------------------------------------

def tilted_plane(n=10, slope=0.1, cellsize=10.0):
    rows = np.arange(n)[:, None] * np.ones((1, n))
    return (n - rows) * slope * cellsize


def v_valley(n=15):
    rows, cols = np.mgrid[0:n, 0:n]
    return 100.0 + (n - 1 - rows) * 0.5 + np.abs(cols - n // 2) * 2.0


def two_valleys(n=15):
    rows, cols = np.mgrid[0:n, 0:n]
    return 100.0 + (n - 1 - rows) * 0.5 - np.abs(cols - 7) * 3.0


def seeded_hills(n=24):
    """A seeded rough DEM with pits and a NODATA hole."""
    rng = np.random.default_rng(4)
    rows, cols = np.mgrid[0:n, 0:n]
    dem = 50.0 + (n - rows) * 1.5 + np.abs(cols - n / 2) + rng.uniform(0, 3, (n, n))
    dem[5:7, 9:11] = -9999.0
    return dem


DEMS = {"tilted": tilted_plane, "valley": v_valley, "two_valleys": two_valleys,
        "seeded": seeded_hills}


def headers(dem, cellsize=10.0):
    kw = dict(nrows=dem.shape[0], ncols=dem.shape[1], xllcorner=0.0,
              yllcorner=0.0, cellsize=cellsize, nodata=-9999.0)
    return JHeader(**kw), THeader(**kw)


@pytest.mark.parametrize("name", list(DEMS))
def test_d8_and_accumulation_match_jax(name):
    dem = DEMS[name]()
    same(TW.d8_flow_direction(dem, 10.0), JW.d8_flow_direction(dem, 10.0))
    same(TW.flow_accumulation(dem, 10.0), JW.flow_accumulation(dem, 10.0))


@pytest.mark.parametrize("name", ["valley", "two_valleys", "seeded"])
def test_basin_extraction_matches_jax(name):
    """extract_basin (three single-step rounds), clean_basin and
    clean_basin_simple from the outlet: the same rasters and headers."""
    dem = DEMS[name]()
    jh, th = headers(dem)
    col = 0 if name == "two_valleys" else dem.shape[1] // 2
    x, y = (col + 0.5) * 10.0, 0.5 * 10.0
    same(TW.extract_basin(dem, th, x, y), JW.extract_basin(dem, jh, x, y))
    same(TW.clean_basin(dem, th, x, y), JW.clean_basin(dem, jh, x, y))
    basin = np.where(dem > dem.mean(), -9999.0, dem)
    same(TW.clean_basin_simple(dem, basin, th, x, y),
         JW.clean_basin_simple(dem, basin, jh, x, y))


def test_basin_helpers_match_jax():
    """cut_empty_frame, remove_disconnected_areas and
    add_terrain_depressions on test_watershed.py's rasters; the same errors
    for a closure outside the grid and on NODATA."""
    dem = np.full((10, 12), -9999.0)
    dem[3:7, 4:9] = 5.0
    jh, th = headers(dem)
    same(TW.cut_empty_frame(dem, th), JW.cut_empty_frame(dem, jh))
    basin = np.full((9, 9), -9999.0)
    basin[0:3, 0:3] = 1.0
    basin[5:9, 5:9] = 2.0
    same(TW.remove_disconnected_areas(basin, 6, 6), JW.remove_disconnected_areas(basin, 6, 6))
    dem2 = np.full((9, 9), 10.0)
    b2 = dem2.copy()
    b2[4, 4] = -9999.0
    b2[0, 0] = -9999.0
    same(TW.add_terrain_depressions(dem2, b2), JW.add_terrain_depressions(dem2, b2))
    hills = seeded_hills()
    jh, th = headers(hills)
    for x, y in ((-50.0, 10.0), (95.0, 175.0)):      # outside; on the hole
        with pytest.raises(ValueError) as ej:
            JW.extract_basin_single_step(hills, jh, x, y)
        with pytest.raises(ValueError, match=str(ej.value)):
            TW.extract_basin_single_step(hills, th, x, y)


def run_isolated(code: str):
    """``code`` in a fresh interpreter with the repository on the path."""
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                         capture_output=True, text=True, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_scipy_and_h5py_only_inside_the_functions(tmp_path):
    """Importing watershed and netcdf loads no scipy; with scipy (or h5py)
    missing, the functions that need it raise ImportError — JAX's
    watershed and netcdf fail to import then, and JAX's NetCDF-4 read
    raises with the message the port's gives."""
    path = str(tmp_path / "f.nc")
    out = run_isolated(f"""
        import sys
        from criteria3d_tpu_torch.core import watershed
        from criteria3d_tpu_torch.io import netcdf
        print("scipy" in sys.modules)
        sys.modules["scipy"] = sys.modules["scipy.io"] = None
        sys.modules["scipy.ndimage"] = sys.modules["h5py"] = None
        import numpy as np
        for f in (lambda: watershed.add_terrain_depressions(np.ones((3, 3)), np.ones((3, 3))),
                  lambda: netcdf.export_raster({path!r}, np.ones((2, 2)), None)):
            try:
                f()
            except ImportError:
                print("ImportError")
        open({path!r}, "wb").write(b"\\x89HDF\\r\\n\\x1a\\n" + bytes(64))
        try:
            netcdf.NetCDFHandler().read({path!r})
        except ImportError as e:
            print(e)
    """).split("\n")
    assert out[:4] == ["False", "ImportError", "ImportError",
                       "reading NetCDF-4/HDF5 files requires h5py"]


# ---------------------------------------------------------------------------
# NetCDF (test_netcdf.py's rasters)
# ---------------------------------------------------------------------------

def netcdf_state(h):
    """What a NetCDFHandler read: flags, axes, variables, times."""
    out = {k: getattr(h, k) for k in ("is_utm", "is_lat_lon", "is_rotated", "is_hourly",
                                      "is_daily", "missing_value", "x", "y", "lat", "lon",
                                      "time", "time_unit")}
    out["variables"] = [dataclasses.asdict(v) for v in h.variables]
    out["nr_time"] = h.nr_time
    if h.is_time_readable():
        out["times"] = [h.get_time(i) for i in range(h.nr_time)]
        out["stamps"] = [h.get_datetime_str(i) for i in range(h.nr_time)]
    out["metadata"] = h.get_metadata()
    return out


def read_both(path, var, n_time=1):
    hj, ht = JN.NetCDFHandler().read(path), TN.NetCDFHandler().read(path)
    try:
        same(netcdf_state(ht), netcdf_state(hj))
        for t in range(n_time):
            same(ht.extract_raster(var, time_index=t), hj.extract_raster(var, time_index=t))
    finally:
        hj.close()
        ht.close()


def nc_header(cls, nrows=6, ncols=8, cellsize=100.0):
    return cls(nrows=nrows, ncols=ncols, xllcorner=700000.0, yllcorner=4900000.0,
               cellsize=cellsize, nodata=-9999.0)


@pytest.mark.parametrize("case", ["utm", "series", "latlon"])
def test_netcdf_export_byte_identical_and_read_equal(tmp_path, case):
    """export_raster (UTM, lat-lon) and export_series (hours-since axis)
    write the same bytes; both handlers read each file equal."""
    a, b = both_dirs(tmp_path)
    if case == "utm":
        grid = np.arange(48, dtype=float).reshape(6, 8)
        kw = dict(var_name="WP", unit="m", long_name="water potential")
        JN.export_raster(str(a / "f.nc"), grid, nc_header(JHeader), **kw)
        TN.export_raster(str(b / "f.nc"), grid, nc_header(THeader), **kw)
        var, n_time = "WP", 1
    elif case == "series":
        grids = np.stack([np.full((4, 4), float(i)) for i in range(5)])
        times = [dt.datetime(2024, 5, 1, 0) + dt.timedelta(hours=i) for i in range(5)]
        JN.export_series(str(a / "f.nc"), grids, nc_header(JHeader, 4, 4), times,
                         var_name="PREC", unit="mm")
        TN.export_series(str(b / "f.nc"), grids, nc_header(THeader, 4, 4), times,
                         var_name="PREC", unit="mm")
        var, n_time = "PREC", 5
    else:
        kw = dict(nrows=5, ncols=5, xllcorner=11.0, yllcorner=44.0, cellsize=0.1,
                  nodata=-9999.0)
        grid = np.random.default_rng(1).normal(size=(5, 5))
        JN.export_raster(str(a / "f.nc"), grid, JHeader(**kw), var_name="T2M", is_utm=False)
        TN.export_raster(str(b / "f.nc"), grid, THeader(**kw), var_name="T2M", is_utm=False)
        var, n_time = "T2M", 1
    files_equal(a, b, ["f.nc"])
    read_both(str(b / "f.nc"), var, n_time)


def test_netcdf4_hdf5_read_matches_jax(tmp_path):
    """test_netcdf4_hdf5_read's chunked, deflated CF file (h5py, installed
    here): both handlers read it equal."""
    h5py = pytest.importorskip("h5py")
    path = str(tmp_path / "nc4.nc")
    R, C, T = 10, 14, 3
    data = np.arange(T * R * C, dtype=np.float32).reshape(T, R, C)
    data[0, 0, 0] = -9999.0
    with h5py.File(path, "w") as f:
        dlat = f.create_dataset("lat", data=44.0 + 0.01 * np.arange(R))
        dlon = f.create_dataset("lon", data=9.0 + 0.01 * np.arange(C))
        dtime = f.create_dataset("time", data=np.array([0.0, 1.0, 2.0]))
        for d, nm in ((dlat, "lat"), (dlon, "lon"), (dtime, "time")):
            d.make_scale(nm)
        dlat.attrs["units"] = b"degrees_north"
        dlon.attrs["units"] = b"degrees_east"
        dtime.attrs["units"] = b"hours since 2021-06-01 12:00"
        v = f.create_dataset("tair", data=data, chunks=(1, R, C), compression="gzip",
                             shuffle=True)
        for i, s in enumerate((dtime, dlat, dlon)):
            v.dims[i].attach_scale(s)
        v.attrs["long_name"] = b"air temperature"
        v.attrs["units"] = b"degC"
        v.attrs["_FillValue"] = np.float32(-9999.0)
    read_both(path, "tair", T)


# ---------------------------------------------------------------------------
# shapefiles (test_shapefile.py's two squares)
# ---------------------------------------------------------------------------

def square(x0, y0, size):
    return np.array([[x0, y0], [x0, y0 + size], [x0 + size, y0 + size],
                     [x0 + size, y0], [x0, y0]])


def two_squares(mod, path):
    h = mod.ShapeHandler()
    h.new_shapefile(str(path / "zones.shp"), mod.POLYGON)
    h.fields = [mod.DbfField("ID", "N", 10, 0), mod.DbfField("NAME", "C", 16, 0),
                mod.DbfField("VAL", "F", 12, 3)]
    h.add_shape(mod.ShapeObject(mod.POLYGON, [square(0, 0, 100)]),
                {"ID": 1, "NAME": "west", "VAL": 1.5})
    h.add_shape(mod.ShapeObject(mod.POLYGON, [square(100, 0, 100)]),
                {"ID": 2, "NAME": "east", "VAL": 2.5})
    h.save()
    return h


SHP = ["zones.shp", "zones.shx", "zones.dbf"]


def test_shapefile_polygons_byte_identical(tmp_path):
    """Write, reopen, delete a record, save and pack: the same files at each
    step and equal handlers; the .prj's UTM zone parsed equal."""
    a, b = both_dirs(tmp_path)
    hj, ht = two_squares(JS, a), two_squares(TS, b)
    files_equal(a, b, SHP)
    # one file read by both (the handlers keep its path)
    oj, ot = JS.ShapeHandler().open(str(a / "zones.shp")), TS.ShapeHandler().open(str(a / "zones.shp"))
    same(ot, oj)
    for x, y in ((50, 50), (150, 50), (250, 50), (100, 50)):
        assert ot.get_shape_index_from_point(x, y) == oj.get_shape_index_from_point(x, y)
    for h in (hj, ht):
        h.delete_record(0)
        h.save()
    files_equal(a, b, SHP)
    for d in (a, b):
        (d / "zones.prj").write_text('PROJCS["WGS_1984_UTM_Zone_33S",GEOGCS["GCS_WGS_1984"]]')
    oj, ot = JS.ShapeHandler().open(str(a / "zones.shp")), TS.ShapeHandler().open(str(b / "zones.shp"))
    assert (ot.is_wgs84, ot.utm_zone, ot.is_north) == (oj.is_wgs84, oj.utm_zone, oj.is_north)
    for h in (oj, ot):
        h.pack()
        h.save()
    files_equal(a, b, SHP)
    same(TS.ShapeHandler().open(str(a / "zones.shp")), JS.ShapeHandler().open(str(a / "zones.shp")))


def test_shapefile_points_lines_and_holes(tmp_path):
    a, b = both_dirs(tmp_path)
    for mod, d in ((JS, a), (TS, b)):
        h = mod.ShapeHandler()
        h.new_shapefile(str(d / "pts.shp"), mod.POINT)
        h.fields = [mod.DbfField("ID", "N", 6, 0)]
        h.add_shape(mod.ShapeObject(mod.POINT, [np.array([[12.5, 44.5]])]), {"ID": 7})
        h.save()
        h = mod.ShapeHandler()
        h.new_shapefile(str(d / "lines.shp"), mod.POLYLINE)
        h.fields = [mod.DbfField("ID", "N", 6, 0), mod.DbfField("W", "F", 10, 4)]
        h.add_shape(mod.ShapeObject(mod.POLYLINE, [np.array([[0., 0.], [10., 5.], [20., 0.]])]),
                    {"ID": 1, "W": 0.125})
        h.save()
    files_equal(a, b, [f"{n}.{e}" for n in ("pts", "lines") for e in ("shp", "shx", "dbf")])
    outer, hole = square(0, 0, 100), square(40, 40, 20)[::-1]
    sj = JS.ShapeObject(JS.POLYGON, [outer, hole])
    st = TS.ShapeObject(TS.POLYGON, [outer, hole])
    for x, y in ((10, 10), (50, 50), (150, 50), (0, 0), (40, 50)):
        assert st.contains(x, y) == sj.contains(x, y)
    assert [st.is_hole(i) for i in (0, 1)] == [sj.is_hole(i) for i in (0, 1)]
    assert st.bounds == sj.bounds and st.vertex_count == sj.vertex_count


def test_shape_utils_match_jax(tmp_path):
    """Rasterization, the zone index raster, zonal statistics (every
    aggregation, with a NODATA threshold, and written to a field),
    the majority, the CSV join and the clone: equal rasters and values,
    byte-identical files."""
    a, b = both_dirs(tmp_path)
    hj, ht = two_squares(JS, a), two_squares(TS, b)
    same(TSU.rasterize_shape(ht, "VAL", cellsize=10.0), JSU.rasterize_shape(hj, "VAL", cellsize=10.0))
    zj, hdrj = JSU.initialize_raster_from_shape(hj, 10.0)
    zt, hdrt = TSU.initialize_raster_from_shape(ht, 10.0)
    JSU.fill_raster_with_shape_index(zj, hdrj, hj)
    TSU.fill_raster_with_shape_index(zt, hdrt, ht)
    same(zt, zj)
    same(dataclasses.asdict(hdrt), dataclasses.asdict(hdrj))
    rng = np.random.default_rng(3)
    values = rng.integers(0, 5, zj.shape).astype(float)
    values[:, :3] = -9999.0
    for how in ("AVG", "MIN", "MAX", "MEDIAN", "STDEV", "MAJORITY"):
        for thr in (None, 0.5, 0.9):
            kw = {} if thr is None else dict(threshold=thr)
            same(TSU.zonal_statistics_vector(zt, values, 2, how, **kw),
                 JSU.zonal_statistics_vector(zj, values, 2, how, **kw))
    same(TSU.zonal_statistics_shape(ht, zt, values, "XMEAN"),
         JSU.zonal_statistics_shape(hj, zj, values, "XMEAN"))
    same(TSU.zonal_statistics_shape_majority(ht, zt, values, "XMAJ"),
         JSU.zonal_statistics_shape_majority(hj, zj, values, "XMAJ"))
    for d in (a, b):
        (d / "attrs.csv").write_text("ID,CROP,YIELD\n1,MAIZE,11.5\n2,WHEAT,6.0\n")
    assert TSU.shape_from_csv(ht, str(b / "attrs.csv"), "ID") == \
        JSU.shape_from_csv(hj, str(a / "attrs.csv"), "ID")
    hj.save()
    ht.save()
    files_equal(a, b, SHP)
    JSU.clone_shape_file(str(a / "zones.shp"), str(a / "copy.shp"))
    TSU.clone_shape_file(str(b / "zones.shp"), str(b / "copy.shp"))
    files_equal(a, b, ["copy.shp", "copy.shx", "copy.dbf"])


# ---------------------------------------------------------------------------
# reprojection (test_reproject.py's points, ring and rasters)
# ---------------------------------------------------------------------------

def test_transform_points_and_shapes_match_jax():
    x = np.array([680000.0, 681000.0, 685000.0, 695000.0])
    y = np.array([4950000.0, 4951000.0, 4960000.0, 4950000.0])
    for src, dst in (((("utm", 32)), ("latlon",)), (("utm", 32), ("utm", 33)),
                     (("utm", 32, -30.0), ("latlon",))):
        same(TR.transform_points(x, y, src, dst), JR.transform_points(x, y, src, dst))
    lon, lat = JR.transform_points(x, y, ("utm", 32), ("latlon",))
    same(TR.transform_points(lon, lat, ("latlon",), ("utm", 32)),
         JR.transform_points(lon, lat, ("latlon",), ("utm", 32)))
    ring = np.array([[680000.0, 4950000.0], [681000.0, 4950000.0], [681000.0, 4951000.0],
                     [680000.0, 4951000.0], [680000.0, 4950000.0]])
    sj = JR.reproject_shape(JS.ShapeObject(5, [ring]), ("utm", 32), ("latlon",))
    st = TR.reproject_shape(TS.ShapeObject(5, [ring]), ("utm", 32), ("latlon",))
    same(st.parts, sj.parts)
    same(TR.reproject_shapes([st], ("latlon",), ("utm", 32))[0].parts,
         JR.reproject_shapes([sj], ("latlon",), ("utm", 32))[0].parts)


@pytest.mark.parametrize("method", ["bilinear", "nearest"])
def test_reproject_raster_matches_jax(method):
    """test_raster_warp_roundtrip's smooth raster (with a NODATA cell) to
    lat-lon and back onto its own header: equal values and headers."""
    R, C = 40, 50
    kw = dict(nrows=R, ncols=C, xllcorner=680000.0, yllcorner=4950000.0,
              cellsize=100.0, nodata=-9999.0)
    xs = 680000.0 + (np.arange(C) + 0.5) * 100.0
    ys = 4950000.0 + (R - 0.5 - np.arange(R)) * 100.0
    xx, yy = np.meshgrid(xs, ys)
    vals = 1e-3 * (xx - xs.min()) + 2e-3 * (yy - ys.min())
    vals[0, 0] = -9999.0
    vj, hj = JR.reproject_raster(vals, JHeader(**kw), ("utm", 32), ("latlon",), method=method)
    vt, ht = TR.reproject_raster(vals, THeader(**kw), ("utm", 32), ("latlon",), method=method)
    same(vt, vj)
    same(dataclasses.asdict(ht), dataclasses.asdict(hj))
    same(TR.reproject_raster(vt, ht, ("latlon",), ("utm", 32), out_header=THeader(**kw),
                             method=method),
         tuple(x if not hasattr(x, "cellsize") else THeader(**dataclasses.asdict(x))
               for x in JR.reproject_raster(vj, hj, ("latlon",), ("utm", 32),
                                            out_header=JHeader(**kw), method=method)))


# ---------------------------------------------------------------------------
# XML import, forecast dataset (test_import_xml.py, test_forecast_dataset.py)
# ---------------------------------------------------------------------------

import_cases = {}
for _name in ("XML_CSV", "CSV", "XML_FIXED", "FIXED", "XML_FULL_FIXED", "FULL_FIXED"):
    import_cases[_name] = getattr(__import__("tests.test_import_xml", fromlist=[_name]), _name)
MULTI_XML = """<?xml version="1.0"?>
<ImportData>
  <format><type>fixed</type><attribute>MULTIPOINT</attribute></format>
  <time><type>HOURLY</type><firstchar>6</firstchar><nrchar>16</nrchar>
        <format>yyyy-MM-dd HH:mm</format></time>
  <pointcode><firstchar>1</firstchar><nrchar>4</nrchar></pointcode>
  <variable>
    <field><name>airTemperature</name><format>%f</format>
           <firstchar>23</firstchar><nrchar>6</nrchar></field>
  </variable>
</ImportData>
"""
MULTI = ("S001 2023-05-01 00:00  12.5\n"
         "S002 2023-05-01 00:00  10.1\n"
         "S001 2023-05-01 01:00  12.9\n")


@pytest.mark.parametrize("case", ["delimited", "fixed", "full_fixed", "multipoint"])
def test_xml_import_matches_jax(tmp_path, case):
    """The four descriptors of test_import_xml.py: the parsed format and
    the imported table equal (times, points, values, error counts)."""
    xml, data, name = {
        "delimited": (import_cases["XML_CSV"], import_cases["CSV"], "data.csv"),
        "fixed": (import_cases["XML_FIXED"], import_cases["FIXED"], "data.txt"),
        "full_fixed": (import_cases["XML_FULL_FIXED"], import_cases["FULL_FIXED"],
                       "st_MILO_day.txt"),
        "multipoint": (MULTI_XML, MULTI, "multi.txt")}[case]
    (tmp_path / "fmt.xml").write_text(xml)
    (tmp_path / name).write_text(data)
    fj = JX.parse_import_xml(str(tmp_path / "fmt.xml"))
    ft = TX.parse_import_xml(str(tmp_path / "fmt.xml"))
    same(ft, fj)
    same(TX.import_data(str(tmp_path / name), ft), JX.import_data(str(tmp_path / name), fj))
    spec_j, spec_t = (m.FieldSpec(first_char=1, nr_char=4, format="%d") for m in (JX, TX))
    for k in range(3):
        assert spec_t.value("  12  34  56", [], False, n_replication=k) == \
            spec_j.value("  12  34  56", [], False, n_replication=k)


def test_forecast_dataset_matches_jax(tmp_path):
    """test_forecast_dataset.py's two days of TAVG and PREC with the
    hour-0 rollover, and a broken line: the same counts and blocks."""
    rows = []
    for day in (1, 2):
        for hour in range(24):
            rows.append(f"44.5,11.3,55.0,TAVG,2023,7,{day},{hour},{20 + hour * 0.1 + day}")
            rows.append(f"44.5,11.3,55.0,PREC,2023,7,{day},{hour},0.0")
    rows.append("44.6,11.4,60.0,TAVG,2023,7,2,5,18.5")
    rows.append("not,a,row")
    (tmp_path / "f.csv").write_text("\n".join(rows) + "\n")
    dj, dt_ = JFD.ForecastDataset(), TFD.ForecastDataset()
    assert dt_.import_file(str(tmp_path / "f.csv")) == dj.import_file(str(tmp_path / "f.csv"))
    assert dt_.dates() == dj.dates()
    for d in dj.dates():
        assert dt_.points(d) == dj.points(d)
        for p in dj.points(d):
            assert dt_.point_index(d, *p) == dj.point_index(d, *p)
            for var in ("TAVG", "PREC", "RAD"):
                same(dt_.hourly_values(d, p, var), dj.hourly_values(d, p, var))


# ---------------------------------------------------------------------------
# CRITERIA-1D outputs and the utility DBs
# ---------------------------------------------------------------------------

def unit_db(path):
    """test_criteria_output.py's unit_db fixture, in a file."""
    db = sqlite3.connect(str(path))
    db.execute('CREATE TABLE "CASE1" (DATE TEXT, TRANSP_MAX REAL, TRANSP REAL, '
               "IRRIGATION REAL, LAI REAL)")
    d0 = dt.date(2024, 6, 1)
    for i in range(200):
        db.execute('INSERT INTO "CASE1" VALUES (?,?,?,?,?)',
                   ((d0 + dt.timedelta(days=i)).isoformat(), 4.0,
                    3.0 - 0.01 * (i % 13), 10.0 if i % 7 == 0 else 0.0, 2.0 + 0.01 * i))
    db.commit()
    return db


def db_dump(db) -> list:
    return list(db.iterdump())


def test_dtx_and_unit_db_match_jax(tmp_path):
    """compute_dtx (with NODATA in a window, a negative deficit), DT30 /
    DT90 / DT180 of a unit and their write-back (the same DB content),
    select_simple_var for each computation and compute_dtx_var: equal."""
    tm = np.full(40, 5.0)
    tr = np.full(40, 3.0) - 0.1 * np.arange(40) % 3
    tr[35] = JC.NODATA
    for n in (7, 30):
        same(TC.compute_dtx(tm, tr, n), JC.compute_dtx(tm, tr, n))
    same(TC.compute_dtx(np.full(30, 2.0), np.full(30, 3.0), 30),
         JC.compute_dtx(np.full(30, 2.0), np.full(30, 3.0), 30))
    dbj, dbt = unit_db(tmp_path / "j.db"), unit_db(tmp_path / "t.db")
    rj, rt = JC.compute_all_dtx_unit(dbj, "CASE1"), TC.compute_all_dtx_unit(dbt, "CASE1")
    same(rt, rj)
    JC.write_dtx_to_db(dbj, "CASE1", *rj)
    TC.write_dtx_to_db(dbt, "CASE1", *rt)
    assert db_dump(dbt) == db_dump(dbj)
    first, last = dt.date(2024, 6, 1), dt.date(2024, 6, 30)
    for var, comp, kw in (("TRANSP", "SUM", {}), ("LAI", "MAX", {}), ("LAI", "MIN", {}),
                          ("LAI", "AVG", {}), ("LAI", "", {}),
                          ("IRRIGATION", "SUM", dict(irri_ratio=0.5))):
        same(TC.select_simple_var(dbt, "CASE1", var, comp, first, last, **kw),
             JC.select_simple_var(dbj, "CASE1", var, comp, first, last, **kw))
    for day in (dt.date(2024, 8, 1), dt.date(2024, 6, 5)):
        same(TC.compute_dtx_var(dbt, "CASE1", 30, "", day, day),
             JC.compute_dtx_var(dbj, "CASE1", 30, "", day, day))


def test_criteria_output_csvs_byte_identical(tmp_path):
    """The variable and aggregation lists parsed equal; the unit CSV
    (two units, then sorted by ID_CASE) and the aggregation CSV from a
    shapefile byte-identical."""
    a, b = both_dirs(tmp_path)
    text = ("output var name,var name,reference day,computation,nr days,"
            "climate computation,param1,param2\n"
            "TRANSP_SUM,TRANSP,-29,SUM,30,,0,0\nLAI_MAX,LAI,0,MAX,10,,0,0\n"
            "DT30,DT30,0,,1,,0,0\n")
    aggr = "output var name,input field name,aggregation type\nTAVG,TRANSP_SUM,AVG\n"
    for d in (a, b):
        (d / "vars.csv").write_text(text)
        (d / "aggr.csv").write_text(aggr)
    same(TC.OutputVariableList.parse(str(b / "vars.csv")),
         JC.OutputVariableList.parse(str(a / "vars.csv")))
    same(TC.AggregationVariableList.parse(str(b / "aggr.csv")),
         JC.AggregationVariableList.parse(str(a / "aggr.csv")))
    for mod, d in ((JC, a), (TC, b)):
        db = unit_db(d / "u.db")
        db.execute('CREATE TABLE "ACASE" AS SELECT * FROM "CASE1"')
        variables = mod.OutputVariableList.parse(str(d / "vars.csv"))
        for case in ("CASE1", "ACASE"):
            mod.write_csv_output_unit(case, "MAIZE", db, dt.date(2024, 8, 1), variables,
                                      str(d / "out.csv"))
        mod.order_csv_by_field(str(d / "out.csv"), "ID_CASE")
        shp = {JC: JS, TC: TS}[mod]
        h = shp.ShapeHandler()
        h.new_shapefile(str(d / "r.shp"), shp.POLYGON)
        h.fields = [shp.DbfField("ZONE", "C", 8, 0), shp.DbfField("TAVG", "N", 12, 2)]
        sq_ = np.array([[0, 0], [0, 10], [10, 10], [10, 0], [0, 0]], float)
        h.add_shape(shp.ShapeObject(shp.POLYGON, [sq_]), {"ZONE": "A", "TAVG": 3.25})
        h.add_shape(shp.ShapeObject(shp.POLYGON, [sq_ + 10]), {"ZONE": "B", "TAVG": 4.5})
        assert mod.write_csv_aggregation_from_shape(
            h, str(d / "aggr_out.csv"), dt.date(2024, 8, 1), ["TAVG"], ["TAVG_OUT"],
            "ZONE") == 2
    files_equal(a, b, ["out.csv", "aggr_out.csv"])


def test_utility_dbs_byte_identical(tmp_path):
    """test_utility_dbs_roundtrip's water-table parameters and computation
    units: the same DB files, read back equal (the missing well's error
    too); the read-back model predicts the same depth."""
    a, b = both_dirs(tmp_path)
    for mod, wt, d in ((JU, JWT, a), (TU, TWT, b)):
        wdb = mod.WaterTableParamsDb(str(d / "wt.db"))
        wdb.write("W01", wt(h0=142.0, alpha=-1.1, nr_days=185, avg_daily_cwb=-0.8, r2=0.93),
                  lat=44.8, lon=11.6)
        cdb = mod.ComputationUnitsDb(str(d / "units.db"))
        cdb.write_units([
            mod.ComputationUnit(id_case="CASE001", id_crop="MAIZE", id_meteo="S1",
                                id_soil="SOIL7", id_water_table="W01", hectares=12.5,
                                use_water_table=True),
            mod.ComputationUnit(id_case="CASE002", id_crop="WHEAT", id_meteo="S2",
                                id_soil="SOIL3", hectares=4.0)])
    files_equal(a, b, ["wt.db", "units.db"])
    gj, latj, lonj = JU.WaterTableParamsDb(str(a / "wt.db")).read("W01")
    gt, latt, lont = TU.WaterTableParamsDb(str(b / "wt.db")).read("W01")
    same(vars(gt), vars(gj))
    assert (latt, lont) == (latj, lonj)
    prec, et0 = np.full(400, 2.0), np.full(400, 2.5)
    assert gt.depth(prec, et0, 390) == gj.depth(prec, et0, 390)
    with pytest.raises(KeyError, match="Missing waterTable ID"):
        TU.WaterTableParamsDb(str(b / "wt.db")).read("W99")
    same(TU.ComputationUnitsDb(str(b / "units.db")).read_units(),
         JU.ComputationUnitsDb(str(a / "units.db")).read_units())

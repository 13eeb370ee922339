"""The port's native raster writer pool (``native.AsyncRasterWriter`` over
``csrc/output_writer.cpp``) against the synchronous writer and the JAX
package's pool.

The inputs are those of tests/test_native.py (eight seeded 40 x 30 float32
grids, a constant grid mutated after ``submit``) and the output maps of
``problems.write_project(n=8)`` hours. The library builds with g++ into
``criteria3d_tpu_torch/build/``, keyed by the host (``utils/buildcache.py``);
the files it writes are byte-identical to ``io.esri.write_flt``'s and to the
JAX pool's; where the build fails the pool writes synchronously, as the
JAX package's does, and logs it once.
"""

import datetime
import logging
import os

import numpy as np
import pytest

from criteria3d_tpu import native as JN
from criteria3d_tpu.io.esri import RasterHeader as JHeader
from criteria3d_tpu_torch import native as TN
from criteria3d_tpu_torch import outputs as TO
from criteria3d_tpu_torch import problems
from criteria3d_tpu_torch.device import host_read
from criteria3d_tpu_torch.io.esri import RasterHeader, read_flt, write_flt
from criteria3d_tpu_torch.project import Criteria3DProject
from criteria3d_tpu_torch.utils import buildcache

HDR = dict(nrows=40, ncols=30, xllcorner=1000.0, yllcorner=2000.0, cellsize=25.0,
           nodata=-9999.0)


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_library_builds_into_the_package_build_dir():
    path = TN.build_library()
    assert os.path.dirname(path) == TN.BUILD_DIR
    assert TN.BUILD_DIR == os.path.join(os.path.dirname(TN.__file__), "build")
    assert os.path.exists(path) and TN.build_library() == path
    assert not [f for f in os.listdir(os.path.dirname(TN.SOURCE)) if f.endswith(".so")]


def test_async_files_equal_sync_and_jax(tmp_path):
    rng = np.random.default_rng(0)
    grids = [rng.normal(size=(40, 30)).astype(np.float32) for _ in range(8)]
    grids[3][5, 7] = np.nan
    assert TN.native_available() and JN.native_available()
    with TN.AsyncRasterWriter(n_threads=3) as w:
        assert w.is_native
        for i, g in enumerate(grids):
            w.submit(str(tmp_path / f"async_{i}.flt"), g, RasterHeader(**HDR))
        w.flush()
        assert (w.written, w.errors) == (8, 0)
    assert (w.written, w.errors) == (8, 0)
    with JN.AsyncRasterWriter(n_threads=2) as jw:
        for i, g in enumerate(grids):
            jw.submit(str(tmp_path / f"jax_{i}"), g, JHeader(**HDR))
        jw.flush()
    for i, g in enumerate(grids):
        write_flt(str(tmp_path / f"sync_{i}"), g, RasterHeader(**HDR))
        for ext in (".flt", ".hdr"):
            a = read_bytes(tmp_path / f"async_{i}{ext}")
            assert a == read_bytes(tmp_path / f"sync_{i}{ext}")
            assert a == read_bytes(tmp_path / f"jax_{i}{ext}")
        vals, hdr = read_flt(str(tmp_path / f"async_{i}.flt"))
        assert hdr == RasterHeader(**HDR)
        np.testing.assert_array_equal(np.isnan(vals), np.isnan(g))


def test_submit_does_not_retain_the_buffer(tmp_path):
    """The queue copies the data: changing or dropping the array after
    submit does not change the file (float64 input converted first)."""
    data = np.full((40, 30), 7.0, np.float32)
    wide = np.full((40, 30), 3.0)
    with TN.AsyncRasterWriter(n_threads=1) as w:
        w.submit(str(tmp_path / "buf"), data, RasterHeader(**HDR))
        w.submit(str(tmp_path / "wide"), wide, RasterHeader(**HDR))
        data[:] = -1.0
        del wide
        w.flush()
    assert (read_flt(str(tmp_path / "buf.flt"))[0] == 7.0).all()
    assert (read_flt(str(tmp_path / "wide.flt"))[0] == 3.0).all()
    with pytest.raises(RuntimeError, match="closed"):
        w.submit(str(tmp_path / "late"), data, RasterHeader(**HDR))


def test_unwritable_path_counts_an_error(tmp_path):
    with TN.AsyncRasterWriter() as w:
        w.submit(str(tmp_path / "no" / "such" / "dir" / "x"), np.zeros((2, 2)),
                 RasterHeader(nrows=2, ncols=2, xllcorner=0, yllcorner=0, cellsize=1))
        w.submit(str(tmp_path / "ok"), np.zeros((2, 2)),
                 RasterHeader(nrows=2, ncols=2, xllcorner=0, yllcorner=0, cellsize=1))
        w.flush()
        assert (w.written, w.errors) == (1, 1)


class Lines(logging.Handler):
    """The messages of the port's native logger, collected."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@pytest.fixture
def native_log():
    """The native logger's lines during a test, with the library cache
    emptied before and after (a failed build is remembered per source)."""
    handler = Lines()
    log = logging.getLogger("criteria3d_tpu_torch.native")
    log.addHandler(handler)
    TN._library.cache_clear()
    yield handler.lines
    TN._library.cache_clear()
    log.removeHandler(handler)


def test_failed_build_raises(tmp_path, native_log):
    """build_library hides nothing: a source that does not compile, or a
    compiler that is not there, raises with the reason. A pool built from
    it writes synchronously (is_native False) and says so once, naming
    the compiler's error."""
    bad = tmp_path / "broken.cpp"
    bad.write_text('extern "C" void* c3d_writer_create(int n) { return n +; }\n')
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        TN.build_library(str(bad))
    assert "broken.cpp" in str(err.value)
    for _ in range(2):
        with TN.AsyncRasterWriter(source=str(bad)) as w:
            assert not w.is_native
            w.submit(str(tmp_path / "sync.flt"), np.ones((40, 30)), RasterHeader(**HDR))
    assert len(native_log) == 1 and "g++ failed" in native_log[0]
    assert (read_flt(str(tmp_path / "sync.flt"))[0] == 1.0).all()
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        TN.build_library(str(bad), cxx="no-such-compiler")
    assert not [f for f in os.listdir(TN.BUILD_DIR) if f.startswith("tmp")]


def test_writer_falls_back_without_a_compiler(tmp_path, monkeypatch, native_log):
    """With no compiler on the PATH the project's pool writes synchronously:
    is_native False, one log line naming the missing g++, and the hours'
    rasters byte-identical to those the native pool writes for the same
    project; at the writer, the fallback's files are byte-identical to the
    JAX pool's and to write_flt's."""
    def hours(name):
        ini = problems.write_project(str(tmp_path / name), n=8, seed=1, n_stations=6)
        prj = Criteria3DProject.load(ini, output_dir=str(tmp_path / name / "out"))
        prj.initialize(device="cpu")
        prj.run_period(datetime.datetime(*problems.PROJECT_DATE, 10), 2)
        prj._raster_writer.flush()
        root = tmp_path / name / "out" / "rasters"
        return prj._raster_writer, {os.path.relpath(os.path.join(d, f), root):
                                    read_bytes(os.path.join(d, f))
                                    for d, _, fs in os.walk(root) for f in fs}
    native, files_native = hours("native")
    assert native.is_native and native.written == len(files_native) // 2 > 0
    monkeypatch.setenv("PATH", str(tmp_path / "no-compilers-here"))
    TN._library.cache_clear()
    fallback, files_sync = hours("fallback")
    assert not fallback.is_native and not TN.native_available()
    assert files_sync == files_native
    assert len(native_log) == 1 and "g++" in native_log[0] and "write_flt" in native_log[0]
    rng = np.random.default_rng(3)
    grid = rng.normal(size=(40, 30)).astype(np.float32)
    with TN.AsyncRasterWriter() as w, JN.AsyncRasterWriter() as jw:
        assert not w.is_native
        w.submit(str(tmp_path / "port.flt"), grid, RasterHeader(**HDR))
        jw.submit(str(tmp_path / "jax"), grid, JHeader(**HDR))
        jw.flush()
    write_flt(str(tmp_path / "sync"), grid, RasterHeader(**HDR))
    for ext in (".flt", ".hdr"):
        a = read_bytes(tmp_path / f"port{ext}")
        assert a == read_bytes(tmp_path / f"jax{ext}") == read_bytes(tmp_path / f"sync{ext}")
    assert len(native_log) == 1


def test_build_key_rebuilds_on_a_changed_host(tmp_path, monkeypatch):
    """The library's name carries its host key: an unchanged key loads the
    built file again without compiling; another CPU-flag fingerprint or
    another compiler version builds a new one."""
    monkeypatch.setattr(TN, "BUILD_DIR", str(tmp_path))
    first = TN.build_library()
    stamp = os.stat(first).st_mtime_ns
    assert TN.build_library() == first and os.stat(first).st_mtime_ns == stamp
    assert os.path.dirname(first) == str(tmp_path)
    fingerprint = buildcache.machine_fingerprint()
    monkeypatch.setattr(buildcache, "machine_fingerprint", lambda: fingerprint + "x")
    other_host = TN.build_library()
    assert other_host != first and os.path.exists(other_host)
    monkeypatch.setattr(buildcache, "machine_fingerprint", lambda: fingerprint)
    version = buildcache.compiler_version("g++")
    monkeypatch.setattr(buildcache, "compiler_version", lambda cxx: version + "x")
    other_compiler = TN.build_library()
    assert other_compiler not in (first, other_host) and os.path.exists(other_compiler)
    assert sorted(os.listdir(tmp_path)) == sorted(
        os.path.basename(p) for p in (first, other_host, other_compiler))
    assert os.stat(first).st_mtime_ns == stamp


def test_project_hours_written_through_the_pool(tmp_path):
    """Project hours queue their rasters on the pool (one per variable and
    depth an hour, one counted device read each, 0 errors); the files are
    byte-identical to the synchronous writer's for the same staged maps."""
    ini = problems.write_project(str(tmp_path / "p"), n=8, seed=1, n_stations=6)
    prj = Criteria3DProject.load(ini, output_dir=str(tmp_path / "out"))
    prj.initialize(device="cpu")
    day = datetime.datetime(*problems.PROJECT_DATE, 10)
    prj.run_period(day, 2)
    w = prj._raster_writer
    n_maps = sum(len(v) for v in prj.output_variables().values())
    assert isinstance(w, TN.AsyncRasterWriter)
    assert (w.written, w.errors) == (2 * n_maps, 0)
    staged = TO.compute_output_rasters(str(tmp_path / "sync"), "x", prj.grid, prj.params,
                                       prj.model.water, prj.output_variables())
    host_read.count = 0
    TO.flush_staged_rasters(staged)
    assert host_read.count == n_maps
    staged_a = [(p.replace("sync", "async"), m, h) for p, m, h in staged]
    os.makedirs(tmp_path / "async")
    with TN.AsyncRasterWriter() as pool:
        paths = TO.flush_staged_rasters(staged_a, writer=pool)
        pool.flush()
    assert len(paths) == n_maps
    for p, _, _ in staged:
        for ext in (".flt", ".hdr"):
            assert read_bytes(p + ext) == read_bytes(p.replace("sync", "async") + ext)
    last = day + datetime.timedelta(hours=1)
    for p, _, _ in staged:
        name = os.path.basename(p).replace("_x", last.strftime("_%Y%m%d_H%H"))
        path = tmp_path / "out" / "rasters" / last.strftime("%Y%m%d") / name
        assert read_bytes(str(path) + ".flt") == read_bytes(p + ".flt")

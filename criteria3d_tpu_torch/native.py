"""The native (C++) raster writer pool, bound with ctypes.

Counterpart of ``criteria3d_tpu/native/__init__.py``:
:class:`AsyncRasterWriter` queues ESRI .flt/.hdr raster writes onto the
C++ worker threads of ``csrc/output_writer.cpp``, so an hour's output IO
overlaps the next hour's work on the card (the reference writes them
synchronously from its C++ app loop, criteria3DProject.cpp:1274-1283 /
gisIO.cpp). The files are byte-identical to the synchronous
:func:`criteria3d_tpu_torch.io.esri.write_flt`.

The library is compiled at first use with ``g++ -O2 -shared -fPIC
-std=c++17 -pthread`` into ``criteria3d_tpu_torch/build/`` (the file name
carries the hash of the source, the flags, the compiler's version and the
host's CPU flags: ``utils/buildcache.py``). When it cannot be built or
loaded the pool writes synchronously with ``io.esri.write_flt``, as the
JAX package's does, and says so once through ``utils/logger``, naming the
compiler's error: this is a host writer, the files are the same either
way.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import tempfile

import numpy as np

from criteria3d_tpu_torch.utils import buildcache

__all__ = ["AsyncRasterWriter", "native_available", "build_library", "SOURCE",
           "BUILD_DIR"]

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_PKG, "csrc", "output_writer.cpp")
BUILD_DIR = os.path.join(_PKG, "build")
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")


def build_library(source: str = SOURCE, cxx: str = "g++") -> str:
    """Compile ``source`` into ``build/`` (once per source, flags, compiler
    version and host CPU flags) and return the library's path; raises
    RuntimeError with the compiler's output when the build fails."""
    try:
        version = buildcache.compiler_version(cxx)
    except RuntimeError as e:
        raise RuntimeError(f"cannot build the raster writer: {e}") from e
    path = buildcache.library_path(BUILD_DIR, "c3d_writer", source, " ".join(CXX_FLAGS),
                                   version, buildcache.machine_fingerprint())
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        try:
            proc = subprocess.run([cxx, *CXX_FLAGS, source, "-o", tmp],
                                  capture_output=True, text=True, timeout=300)
        except OSError as e:
            raise RuntimeError(f"cannot build the raster writer: {cxx}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(
                f"cannot build the raster writer: {cxx} failed "
                f"({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


@functools.cache
def _library(source: str = SOURCE) -> ctypes.CDLL | None:
    """The loaded library, or None (logged once per source) when it cannot
    be built or loaded."""
    try:
        lib = ctypes.CDLL(build_library(source))
    except (RuntimeError, OSError) as e:
        from criteria3d_tpu_torch.utils.logger import ProjectLogger
        ProjectLogger("native").warning(
            f"the native raster writer is not available ({e}); rasters are "
            "written synchronously with io.esri.write_flt")
        return None
    lib.c3d_writer_create.restype = ctypes.c_void_p
    lib.c3d_writer_create.argtypes = [ctypes.c_int]
    lib.c3d_writer_submit.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    lib.c3d_writer_flush.argtypes = [ctypes.c_void_p]
    lib.c3d_writer_written.restype = ctypes.c_long
    lib.c3d_writer_written.argtypes = [ctypes.c_void_p]
    lib.c3d_writer_errors.restype = ctypes.c_long
    lib.c3d_writer_errors.argtypes = [ctypes.c_void_p]
    lib.c3d_writer_destroy.argtypes = [ctypes.c_void_p]
    return lib


def native_available() -> bool:
    """Whether the C++ writer pool builds and loads on this host."""
    return _library(SOURCE) is not None


def _header_text(header) -> str:
    return (f"ncols         {header.ncols}\n"
            f"nrows         {header.nrows}\n"
            f"xllcorner     {header.xllcorner}\n"
            f"yllcorner     {header.yllcorner}\n"
            f"cellsize      {header.cellsize}\n"
            f"NODATA_value  {header.nodata}\n"
            f"byteorder     LSBFIRST\n")


class AsyncRasterWriter:
    """Queue .flt/.hdr raster writes onto C++ worker threads.

    ``submit`` takes a host array, copies it into the queue and returns at
    once; ``flush`` blocks until the queue drains. ``written`` and
    ``errors`` count the finished jobs. Without the native library
    (``is_native`` False) ``submit`` writes at once with
    :func:`criteria3d_tpu_torch.io.esri.write_flt`, as the JAX package's
    pool does, and the counts stay 0."""

    def __init__(self, n_threads: int = 2, *, source: str = SOURCE):
        self._handle = None
        self._closed = False
        self._closed_counts = (0, 0)
        self._lib = _library(source)
        if self._lib is not None:
            self._handle = ctypes.c_void_p(self._lib.c3d_writer_create(int(n_threads)))

    @property
    def is_native(self) -> bool:
        """Whether the writes go to the C++ worker threads."""
        return self._lib is not None

    def submit(self, path: str, data: np.ndarray, header) -> None:
        if self._closed:
            raise RuntimeError("submit to a closed AsyncRasterWriter")
        base = path[:-4] if path.endswith((".flt", ".hdr")) else path
        arr = np.ascontiguousarray(np.asarray(data), dtype="<f4")
        if self._handle is None:
            from criteria3d_tpu_torch.io.esri import write_flt
            write_flt(base, arr, header)
            return
        self._lib.c3d_writer_submit(
            self._handle, base.encode(), _header_text(header).encode(),
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), arr.size)

    def flush(self) -> None:
        if self._handle is not None:
            self._lib.c3d_writer_flush(self._handle)

    @property
    def written(self) -> int:
        if self._handle is None:
            return self._closed_counts[0]
        return int(self._lib.c3d_writer_written(self._handle))

    @property
    def errors(self) -> int:
        if self._handle is None:
            return self._closed_counts[1]
        return int(self._lib.c3d_writer_errors(self._handle))

    def close(self) -> None:
        """Drain the queue, stop the threads and keep the final counts."""
        self._closed = True
        if self._handle is not None:
            self._lib.c3d_writer_flush(self._handle)
            self._closed_counts = (self.written, self.errors)
            self._lib.c3d_writer_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

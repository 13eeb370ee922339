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
carries the hash of the source and the flags). Unlike the JAX package,
which degrades to the synchronous writer when the build fails, the port
raises, naming the compiler's error: a run never changes its writer
without saying so.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile

import numpy as np

__all__ = ["AsyncRasterWriter", "build_library", "SOURCE", "BUILD_DIR"]

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_PKG, "csrc", "output_writer.cpp")
BUILD_DIR = os.path.join(_PKG, "build")
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")


def build_library(source: str = SOURCE, cxx: str = "g++") -> str:
    """Compile ``source`` into ``build/`` (once per source and flag set)
    and return the library's path; raises RuntimeError with the
    compiler's output when the build fails."""
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode())
    path = os.path.join(BUILD_DIR, f"libc3d_writer_{digest.hexdigest()[:16]}.so")
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
def _library(source: str = SOURCE) -> ctypes.CDLL:
    lib = ctypes.CDLL(build_library(source))
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
    ``errors`` count the finished jobs."""

    def __init__(self, n_threads: int = 2, *, source: str = SOURCE):
        self._handle = None
        self._closed_counts = (0, 0)
        self._lib = _library(source)
        self._handle = ctypes.c_void_p(self._lib.c3d_writer_create(int(n_threads)))

    def submit(self, path: str, data: np.ndarray, header) -> None:
        if self._handle is None:
            raise RuntimeError("submit to a closed AsyncRasterWriter")
        base = path[:-4] if path.endswith((".flt", ".hdr")) else path
        arr = np.ascontiguousarray(np.asarray(data), dtype="<f4")
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

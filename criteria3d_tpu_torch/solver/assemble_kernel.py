"""The float32 Picard assembly on the card: the wrapper of the hand-written
CUDA kernel pair ``criteria3d_tpu_torch/csrc/assemble_fast.cu`` (sm_90a).

``solver/water.py`` ``assemble_fast`` calls :func:`assemble` for CUDA
tensors; its plain PyTorch chain, ``assemble_fast_reference``, runs for CPU
tensors and is what the kernel is held to, bit for bit. The library is
built with ``nvcc`` into a shared library with a plain C interface at first
use (``utils/buildcache.py``) and called through ``ctypes``; nothing here
loads it for CPU tensors.

The kernels take one variant of the chain's branches, chosen from what the
call can observe (:func:`variant`): the retention model, the mean type,
the two ``*_reference_compat`` flags, whether the grid has prescribed or
culvert nodes and whether each heat hook is present. The hooks stay
PyTorch and run between the passes, as the chain runs them:
``boundary_flux_fn(psi, dt)`` is added to pass 1's rate and
``extra_flux_fn(psi, k)`` is evaluated on pass 1's k.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple

import torch

from criteria3d_tpu_torch.device import scalar
from criteria3d_tpu_torch.utils import buildcache

__all__ = ["Variant", "variant", "check_inputs", "assemble", "build_library",
           "SOURCE", "NVCC_FLAGS"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "assemble_fast.cu")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")


class Variant(NamedTuple):
    """The branches of the chain a call takes."""

    modified_vg: bool       # params.wrc_model is MODIFIED_VAN_GENUCHTEN
    mean: int               # params.mean_type: 0 arithmetic, 1 geometric, 2 logarithmic
    courant_compat: bool    # params.courant_reference_compat
    culvert_compat: bool    # params.culvert_reference_compat
    prescribed: bool        # grid.has_prescribed
    culvert: bool           # grid.has_culvert
    extra_hook: bool        # extra_flux_fn is given
    boundary_hook: bool     # boundary_flux_fn is given (run by the wrapper)

    @property
    def bits(self) -> int:
        """The kernels' flags: bit 0 the model, bits 1-2 the mean, then one
        bit a flag in field order."""
        bits = int(self.modified_vg) | self.mean << 1
        for k, on in enumerate(self[2:]):
            bits |= int(on) << (3 + k)
        return bits


def variant(params, grid, extra_flux_fn=None, boundary_flux_fn=None) -> Variant:
    """The branches ``assemble_fast`` takes for ``params``, ``grid`` and the
    hooks (the chain's own tests: ``wrc_model.name``, and ``compute_mean``'s
    arithmetic (0) and geometric (1) means, any other type logarithmic)."""
    return Variant(
        modified_vg=params.wrc_model.name != "VAN_GENUCHTEN",
        mean=int(params.mean_type) if int(params.mean_type) in (0, 1) else 2,
        courant_compat=bool(params.courant_reference_compat),
        culvert_compat=bool(params.culvert_reference_compat),
        prescribed=bool(grid.has_prescribed), culvert=bool(grid.has_culvert),
        extra_hook=extra_flux_fn is not None,
        boundary_hook=boundary_flux_fn is not None)


def build_library(verbose: bool = False) -> str:
    """Compile ``csrc/assemble_fast.cu`` into ``build/`` (once per source,
    flags, nvcc version and the card's compute capability) and return its
    path."""
    return buildcache.build_cuda_library(BUILD_DIR, "assemble_fast", SOURCE, NVCC_FLAGS,
                                         verbose)


_PTRS = ("psi", "psi_old", "se", "sink", "pond", "volume", "bsize", "bslope", "roughness",
         "vg_alpha", "vg_n", "vg_m", "vg_he", "vg_sc", "theta_s", "theta_r", "k_sat",
         "mualem_l", "mualem_den", "lat_dist3d", "dz_lat", "lat_dist2d", "lat_area", "area",
         "z32", "culvert_w", "culvert_h", "culvert_rough", "vert_dist", "prescribed_h", "z",
         "btype", "mask", "dt", "approx", "extra", "b", "c_up", "c_down", "c_lat", "diag",
         "water_flow", "rate", "k", "flow0", "courant")
_SOIL = _PTRS[9:19]


class _Args(ctypes.Structure):
    """``AssembleArgs`` of csrc/assemble_fast.cu."""

    _fields_ = ([(n, ctypes.c_void_p) for n in _PTRS]
                + [("lvr", ctypes.c_float), ("dt_host", ctypes.c_float)]
                + [(n, ctypes.c_int) for n in ("first_host", "dt_kind", "approx_kind",
                                               "flags", "L", "R", "C")])


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_library())
    for fn in (lib.c3d_assemble_pass1, lib.c3d_assemble_pass2):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.c3d_assemble_args_size.restype = ctypes.c_int
    if lib.c3d_assemble_args_size() != ctypes.sizeof(_Args):
        raise RuntimeError("assemble_fast: the library's argument layout differs from "
                           "the wrapper's")
    return lib


def _expect(name, t, dtypes, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"assemble_fast: {name} must be a tensor")
    if t.dtype not in dtypes:
        raise TypeError(f"assemble_fast: {name} must be {' or '.join(map(str, dtypes))}, "
                        f"not {t.dtype}")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"assemble_fast: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"assemble_fast: {name} must be contiguous")
    if t.device != device:
        raise ValueError(f"assemble_fast: {name} is on {t.device}, psi on {device}")


def check_inputs(grid, params, psi, psi_old, se, sink_source, pond, out=None) -> None:
    """Raise unless every array the kernels read or write is of the dtype,
    shape and layout they take (contiguous, on psi's device): the psi carry
    and the outputs float32, the sink, the pond and the grid's own
    elevations and distances float64, as the fast path's float64 state and
    grid hold them; ``out`` is ``(b, c_up, c_down, c_lat, diag, water_flow,
    rate, k)``. Runs for tensors on any device."""
    if params.sweep_dtype != torch.float32:
        raise TypeError(f"assemble_fast: the kernels run the float32 path, not "
                        f"sweep_dtype {params.sweep_dtype}")
    f32, f64 = (torch.float32,), (torch.float64,)
    dev = psi.device
    _expect("psi", psi, f32, None, dev)
    if psi.dim() != 3 or psi.shape[0] < 2:
        raise ValueError(f"assemble_fast: psi must be (L, R, C) with L >= 2, not "
                         f"{tuple(psi.shape)}")
    box = tuple(psi.shape)
    L, R, C = box
    g32 = grid.astype(torch.float32)
    arrays = [("psi_old", psi_old, f32, box), ("se", se, f32, box),
              ("sink_source", sink_source, f64, box), ("pond", pond, f64, (R, C)),
              ("grid.mask", grid.mask, (torch.bool,), box),
              ("grid.btype", grid.btype, (torch.int8,), box),
              ("grid.volume", g32.volume, f32, box), ("grid.bsize", g32.bsize, f32, box),
              ("grid.bslope", g32.bslope, f32, box),
              ("grid.roughness", g32.roughness, f32, (R, C)),
              ("grid.lat_dist3d", g32.lat_dist3d, f32, (8, R, C)),
              ("grid.dz_lat", g32.dz_lat, f32, (8, R, C)),
              ("grid.lat_dist2d", g32.lat_dist2d, f32, (8, 1, 1)),
              ("grid.lat_area", g32.lat_area, f32, (L, 1, 1)),
              ("grid.area", g32.area, f32, ()),
              ("grid.vert_dist", grid.vert_dist, f64, (L, 1, 1))]
    arrays += [(f"grid.soil.{n}", getattr(g32.soil, n), f32, box) for n in _SOIL]
    if grid.has_prescribed:
        arrays += [("grid.prescribed_h", grid.prescribed_h, f64, box),
                   ("grid.z", grid.z, f64, box)]
    if grid.has_culvert:
        arrays += [(f"grid.{n}", getattr(g32, n), f32, (R, C))
                   for n in ("culvert_w", "culvert_h", "culvert_rough")]
        arrays += [("grid.z (float32)", g32.z, f32, box)]
    if out is not None:
        names = ("b", "c_up", "c_down", "c_lat", "diag", "water_flow", "rate", "k")
        arrays += [(f"out.{n}", t, f32, (8,) + box if n == "c_lat" else box)
                   for n, t in zip(names, out)]
    for name, t, dtypes, shape in arrays:
        _expect(name, t, dtypes, shape, dev)


def _launch(fn, name, args, device):
    with torch.cuda.device(device):
        err = fn(ctypes.byref(args), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"assemble_fast: {name} launch failed: CUDA error {err}")


def _step_args(args, dt, approx, dev):
    """The step size and the Picard index as the kernels read them: a 0-d
    float64 or int64 tensor on ``dev`` by its address (another tensor
    converted to it first, which keeps its value), else a host value (a
    float32 rounding of ``dt``, as ``scalar`` makes)."""
    keep = []
    if isinstance(dt, torch.Tensor):
        if dt.device != dev or dt.dtype != torch.float64 or dt.dim():
            dt = scalar(dt, torch.float64, dev).reshape(())
        keep.append(dt)
        args.dt, args.dt_kind = dt.data_ptr(), 1
    else:
        args.dt_host, args.dt_kind = float(dt), 0
    if isinstance(approx, torch.Tensor):
        if approx.device != dev or approx.dtype != torch.int64 or approx.dim():
            # approx == 0 exactly when this is 0
            approx = (approx != 0).to(device=dev, dtype=torch.int64).reshape(())
        keep.append(approx)
        args.approx, args.approx_kind = approx.data_ptr(), 1
    else:
        args.first_host, args.approx_kind = int(int(approx) == 0), 0
    return keep


def assemble(grid, params, psi, psi_old, se, sink_source, pond, approx, dt,
             extra_flux_fn=None, boundary_flux_fn=None, out=None):
    """``assemble_fast`` on CUDA tensors: ``(b, c_up, c_down, c_lat, diag,
    courant, water_flow, rate, k)``, the arrays written into ``out`` (the
    first eight, in that order) when given, else into new tensors;
    ``courant`` is a new 0-d tensor of ``params.dtype``. Launches pass 1, runs
    the hooks, launches pass 2, all on the current stream of psi's card."""
    dev = psi.device
    if dev.type != "cuda":
        raise ValueError(f"assemble_fast's kernels run on CUDA tensors, not {dev}")
    check_inputs(grid, params, psi, psi_old, se, sink_source, pond, out=out)
    lib = _library()
    L, R, C = psi.shape
    if out is None:
        out = tuple(torch.empty((8,) + tuple(psi.shape) if n == 3 else psi.shape,
                                dtype=torch.float32, device=dev) for n in range(8))
    b, c_up, c_down, c_lat, diag, water_flow, rate, k = out
    courant = torch.empty((), dtype=torch.float64, device=dev)
    flow0 = torch.empty((R, C), dtype=torch.float32, device=dev)
    g32 = grid.astype(torch.float32)
    v = variant(params, grid, extra_flux_fn, boundary_flux_fn)

    args = _Args()
    ptrs = dict(psi=psi, psi_old=psi_old, se=se, sink=sink_source, pond=pond,
                volume=g32.volume, bsize=g32.bsize, bslope=g32.bslope,
                roughness=g32.roughness, lat_dist3d=g32.lat_dist3d, dz_lat=g32.dz_lat,
                lat_dist2d=g32.lat_dist2d, lat_area=g32.lat_area, area=g32.area,
                vert_dist=grid.vert_dist, btype=grid.btype, mask=grid.mask, b=b,
                c_up=c_up, c_down=c_down, c_lat=c_lat, diag=diag, water_flow=water_flow,
                rate=rate, k=k, flow0=flow0, courant=courant)
    ptrs.update((n, getattr(g32.soil, n)) for n in _SOIL)
    if grid.has_prescribed:
        ptrs.update(prescribed_h=grid.prescribed_h, z=grid.z)
    if grid.has_culvert:
        ptrs.update(z32=g32.z, culvert_w=g32.culvert_w, culvert_h=g32.culvert_h,
                    culvert_rough=g32.culvert_rough)
    for name, t in ptrs.items():
        setattr(args, name, t.data_ptr())
    args.lvr = float(params.lateral_vertical_ratio)
    keep = _step_args(args, dt, approx, dev)   # tensors the kernels read by address
    args.flags = v.bits
    args.L, args.R, args.C = L, R, C

    _launch(lib.c3d_assemble_pass1, "pass 1", args, dev)
    if boundary_flux_fn is not None:
        # per-iteration boundary flow (the HeatSurface evaporative sink):
        # enters the RHS and the balance like any boundary rate
        rate.add_(boundary_flux_fn(psi, dt).to(torch.float32))
    if extra_flux_fn is not None:
        # RHS-only flux (the thermal water flows) on pass 1's k
        extra = torch.broadcast_to(extra_flux_fn(psi, k).to(torch.float32),
                                   psi.shape).contiguous()
        _expect("extra_flux_fn's flux", extra, (torch.float32,), tuple(psi.shape), dev)
        keep.append(extra)
        args.extra = extra.data_ptr()
    _launch(lib.c3d_assemble_pass2, "pass 2", args, dev)
    if params.dtype != torch.float64:
        courant = courant.to(params.dtype)
    return b, c_up, c_down, c_lat, diag, courant, water_flow, rate, k

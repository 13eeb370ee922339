"""Bundled Jacobi sweeps: the CUDA kernel, its plain PyTorch twin and the
solve loop.

Counterpart of ``criteria3d_tpu/solver/pallas_jacobi.py``: the TPU kernel
``jacobi_bundle`` becomes the hand-written CUDA kernel
``criteria3d_tpu_torch/csrc/jacobi_bundle.cu`` (sm_90a), built with ``nvcc``
into a shared library with a plain C interface at first use and called
through ``ctypes``. :func:`jacobi_bundle` launches it for CUDA tensors and
runs :func:`jacobi_bundle_reference` for CPU tensors; there is no other
fallback.

Semantics, as in the JAX package: K sweeps per call; convergence and
divergence are checked every K sweeps, so a converged system may run up to
K-1 extra sweeps (same fixed point).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np
import torch

from criteria3d_tpu_torch.device import host_read
from criteria3d_tpu_torch.solver.shifts import LATERAL_OFFSETS, shift2d

__all__ = ["jacobi_bundle", "jacobi_bundle_reference", "jacobi_solve_loop",
           "build_library", "SWEEPS_PER_BUNDLE"]

SWEEPS_PER_BUNDLE = 8
THREADS = 256            # threads per block of the sweep kernel

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "jacobi_bundle.cu")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the jacobi_bundle kernel")


def build_library(verbose: bool = False) -> str:
    """Compile ``csrc/jacobi_bundle.cu`` into ``build/`` (once per source
    and flag set: the file name carries their hash) and return its path."""
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    path = os.path.join(BUILD_DIR, f"libjacobi_bundle_{digest.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        if verbose:
            print(proc.stdout + proc.stderr, end="")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_library())
    fn = lib.c3d_jacobi_bundle
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def jacobi_bundle_reference(b, c_up, c_down, c_lat, mask_f, x,
                            K: int = SWEEPS_PER_BUNDLE):
    """Plain PyTorch version of the kernel: K sweeps, then the last sweep's
    psi-weighted L1 norm sum. Same term order, clamp and mask multiply as
    the CUDA kernel and as the Pallas kernel (pallas_jacobi.py:86-127);
    neighbours outside the box read as 0."""
    def sweep(x):
        x_up = torch.zeros_like(x)
        x_up[1:] = x[:-1]
        x_dn = torch.zeros_like(x)
        x_dn[:-1] = x[1:]
        acc = b
        acc = acc + c_up * x_up
        acc = acc + c_down * x_dn
        for kk, (dr, dc) in enumerate(LATERAL_OFFSETS):
            acc = acc + c_lat[kk] * shift2d(x, dr, dc)
        acc[0] = torch.clamp_min(acc[0], 0.0)     # acc is a fresh tensor
        return acc * mask_f

    for _ in range(K - 1):
        x = sweep(x)
    x_prev = x
    x = sweep(x)
    dx = torch.abs(x - x_prev)
    apsi = torch.abs(x)
    w = torch.where(apsi > 1.0, 1.0 / apsi, 1.0)
    return x, (dx * w * mask_f).sum()


def _check(b, c_up, c_down, c_lat, mask_f, x):
    L, R, C = x.shape
    for name, t, shape in (("b", b, (L, R, C)), ("c_up", c_up, (L, R, C)),
                           ("c_down", c_down, (L, R, C)),
                           ("c_lat", c_lat, (8, L, R, C)),
                           ("mask_f", mask_f, (L, R, C)), ("x", x, (L, R, C))):
        if t.device != x.device:
            raise ValueError(f"jacobi_bundle: {name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"jacobi_bundle: {name} must be float32, not {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"jacobi_bundle: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"jacobi_bundle: {name} must be contiguous")


def jacobi_bundle(b, c_up, c_down, c_lat, mask_f, x,
                  K: int = SWEEPS_PER_BUNDLE):
    """Run K Jacobi sweeps; returns ``(x_new, last_sweep_norm_sum)``.

    All tensors float32 and contiguous; b/c_up/c_down/mask_f/x are
    (L, R, C), c_lat is (8, L, R, C). On CUDA tensors this launches the
    kernel of ``csrc/jacobi_bundle.cu`` on the current stream and adds one to
    ``jacobi_bundle.launches``; on CPU tensors it runs the plain version.
    """
    if x.device.type == "cpu":
        return jacobi_bundle_reference(b, c_up, c_down, c_lat, mask_f, x, K)
    if x.device.type != "cuda":
        raise ValueError(f"jacobi_bundle runs on CUDA or CPU tensors, not {x.device}")
    _check(b, c_up, c_down, c_lat, mask_f, x)
    if K < 1:
        raise ValueError(f"jacobi_bundle: K must be >= 1, got {K}")
    L, R, C = x.shape
    out = torch.empty_like(x)
    tmp = torch.empty_like(x)
    partial = torch.empty(-(-R * C // THREADS), dtype=torch.float32,
                          device=x.device)
    norm = torch.empty((), dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.c3d_jacobi_bundle(
            b.data_ptr(), c_up.data_ptr(), c_down.data_ptr(), c_lat.data_ptr(),
            mask_f.data_ptr(), x.data_ptr(), out.data_ptr(), tmp.data_ptr(),
            partial.data_ptr(), norm.data_ptr(), L, R, C, K, THREADS, stream)
    if err != 0:
        raise RuntimeError(f"jacobi_bundle kernel launch failed: CUDA error {err}")
    jacobi_bundle.launches += 1
    return out, norm


jacobi_bundle.launches = 0


def jacobi_solve_loop(b, c_up, c_down, c_lat, mask_f, x0, max_iter: int,
                      tol: float, n_nodes: int, K: int = SWEEPS_PER_BUNDLE):
    """Iterate sweep bundles to convergence; returns ``(x, diverged, n_it)``
    with ``n_it`` in sweeps (a multiple of K).

    The contract of pallas_jacobi.jacobi_solve_loop without ``mesh``: the
    check ``it < max_iter`` comes before each bundle; stop when the
    psi-weighted mean |dx| of the bundle's last sweep drops below ``tol``;
    diverged when it exceeds 10x the best seen (best starts at 1). Every
    comparison is made in float32, as in JAX: the host reads the norm sum
    (one synchronisation per bundle) and divides in float32.
    """
    tol32 = np.float32(tol)
    n32 = np.float32(n_nodes)
    ten = np.float32(10.0)
    best = np.float32(1.0)
    x, it, done, diverged = x0, 0, False, False
    while not done and it < max_iter:
        x, norm_sum = jacobi_bundle(b, c_up, c_down, c_lat, mask_f, x, K=K)
        norm = np.float32(host_read(norm_sum)) / n32
        converged = bool(norm < tol32)
        diverged = (not converged) and bool(norm > best * ten)
        best = np.minimum(best, norm)
        it += K
        done = converged or diverged
    return x, diverged, it

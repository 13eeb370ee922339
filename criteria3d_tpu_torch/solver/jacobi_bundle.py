"""Bundled Jacobi sweeps: the CUDA kernel, its plain PyTorch twin and the
solve loop.

Counterpart of ``criteria3d_tpu/solver/pallas_jacobi.py``: the TPU kernel
``jacobi_bundle`` becomes the hand-written CUDA kernel
``criteria3d_tpu_torch/csrc/jacobi_bundle.cu`` (sm_90a), built with ``nvcc``
into a shared library with a plain C interface at first use and called
through ``ctypes``. :func:`jacobi_bundle` launches its tiled design (the K
sweeps in ceil(K / S) launches over tiles that keep their coefficients on
chip; tile and S from :func:`plan_tiles`, the kernel that runs them from
:func:`tiled_variant`) for CUDA tensors and runs
:func:`jacobi_bundle_reference` for CPU tensors; there is no other
fallback. :func:`jacobi_bundle_per_sweep` launches the library's first
design (one launch per sweep), for measuring the tiled one against only.

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

__all__ = ["jacobi_bundle", "jacobi_bundle_tiled", "jacobi_bundle_per_sweep",
           "jacobi_bundle_reference", "jacobi_solve_loop", "plan_tiles",
           "tiled_variant", "tile_smem", "modelled_passes", "build_library",
           "SWEEPS_PER_BUNDLE"]

SWEEPS_PER_BUNDLE = 8
NORM_THREADS = 256       # columns per first-stage norm block (both designs)
SMEM_PER_BLOCK = 232448  # shared memory a Hopper block may opt in to [bytes]
MAX_THREADS = 512        # threads of a tiled block: 128 registers each
N_COEF = 12              # b, c_up, c_down, mask, 8 x c_lat

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "jacobi_bundle.cu")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def _pitches(TI: int, S: int) -> tuple[int, int, int, int]:
    """(TW, CW, XP, CP) of csrc/jacobi_bundle.cu TileLayout: the x and
    coefficient tile sides and their shared-memory row pitches, which start
    D = (-S) mod 4 cells early so that every TMA box starts on a 16-byte
    column, and are padded to 4 floats."""
    tw = TI + 2 * S
    d = -S % 4
    return tw, tw - 2, _up(d + tw, 4), _up(d + tw - 1, 4)


def tile_smem(L: int, TI: int, S: int) -> int:
    """Shared memory [bytes] of one tiled block: a 128-byte head, the 12
    coefficient arrays of the (TI + 2S - 2)^2 computed columns and three
    copies of the (TI + 2S)^2 x tile (staged, and the two sweep buffers), L
    layers each, at the row pitches of :func:`_pitches`, each region on 128
    bytes."""
    tw, cw, xp, cp = _pitches(TI, S)
    return 128 + 4 * (N_COEF * _up(L * cw * cp, 32) + 3 * _up(L * tw * xp, 32))


def modelled_passes(K: int, TI: int, S: int) -> float:
    """Box-array passes of device memory per bundle under the tiled design:
    each of the ceil(K / S) launches reads the 12 coefficient boxes
    ((TI + 2S - 2) rows) and the x box ((TI + 2S) rows) at the row widths of
    :func:`_pitches`, per TI^2 interior, and writes x once. Overlapping
    rings served by L2 are not subtracted."""
    tw, cw, xp, cp = _pitches(TI, S)
    return -(-K // S) * ((N_COEF * cw * cp + tw * xp) / TI ** 2 + 1)


@functools.cache
def plan_tiles(L: int, K: int) -> tuple[int, int]:
    """The tile side TI (a multiple of 4, for TMA) and the sweeps kept on
    chip S for L layers and K sweeps: the pair with the fewest
    :func:`modelled_passes` (then the larger tile) whose block fits a
    Hopper block's shared memory and 512 threads. S = 1, TI = 4 fits up to
    L = 299."""
    best = None
    for S in range(1, K + 1):
        for TI in range(4, 33, 4):
            if ((TI + 2 * S - 2) ** 2 > MAX_THREADS
                    or tile_smem(L, TI, S) > SMEM_PER_BLOCK):
                break
            key = (modelled_passes(K, TI, S), -TI)
            if best is None or key < best[0]:
                best = (key, TI, S)
    if best is None:
        raise ValueError(f"jacobi_bundle: a column of {L} layers does not fit "
                         f"{SMEM_PER_BLOCK} bytes of shared memory")
    return best[1], best[2]


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
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.c3d_jacobi_bundle.argtypes = [P] * 12 + [I] * 7 + [P]
    lib.c3d_jacobi_bundle.restype = I
    lib.c3d_jacobi_bundle_per_sweep.argtypes = [P] * 10 + [I] * 5 + [P]
    lib.c3d_jacobi_bundle_per_sweep.restype = I
    lib.c3d_jacobi_bundle_resident.argtypes = [I] * 4 + [P] * 8
    lib.c3d_jacobi_bundle_resident.restype = I
    return lib


def jacobi_bundle_reference(b, c_up, c_down, c_lat, mask_f, x,
                            K: int = SWEEPS_PER_BUNDLE, halo: int = 0):
    """Plain PyTorch version of the kernel: K sweeps, then the last sweep's
    psi-weighted L1 norm sum. Same term order, clamp and mask multiply as
    the CUDA kernel and as the Pallas kernel (pallas_jacobi.py:86-127);
    neighbours outside the box read as 0. With ``halo`` > 0 the cells within
    ``halo`` of the box's row or column edges are left out of the norm
    (pallas_jacobi.py:113-122); they still sweep."""
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
    contrib = dx * w * mask_f
    if halo > 0:
        _, R, C = x.shape
        inside = torch.zeros((R, C), dtype=torch.bool, device=x.device)
        inside[halo:R - halo, halo:C - halo] = True
        contrib = torch.where(inside, contrib, 0.0)
    return x, contrib.sum()


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


def _cuda_args(b, c_up, c_down, c_lat, mask_f, x, K, name):
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on CUDA tensors, not {x.device}")
    _check(b, c_up, c_down, c_lat, mask_f, x)
    if K < 1:
        raise ValueError(f"{name}: K must be >= 1, got {K}")
    return [t.data_ptr() for t in (b, c_up, c_down, c_lat, mask_f, x)]


def _launch(fn, name, x, args):
    with torch.cuda.device(x.device):
        err = fn(*args, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def jacobi_bundle(b, c_up, c_down, c_lat, mask_f, x,
                  K: int = SWEEPS_PER_BUNDLE, halo: int = 0):
    """Run K Jacobi sweeps; returns ``(x_new, last_sweep_norm_sum)``.

    All tensors float32 and contiguous; b/c_up/c_down/mask_f/x are
    (L, R, C), c_lat is (8, L, R, C). ``halo`` > 0 leaves the outer ring of
    that width out of the norm (the sharded loop's owner cells). On CUDA
    tensors this launches the tiled kernels of ``csrc/jacobi_bundle.cu`` on
    the current stream, with the tile of :func:`plan_tiles`, and adds one to
    ``jacobi_bundle.launches``; a refused launch or shared-memory request
    raises. On CPU tensors it runs the plain version.
    """
    if x.device.type == "cpu":
        return jacobi_bundle_reference(b, c_up, c_down, c_lat, mask_f, x, K, halo)
    out = jacobi_bundle_tiled(b, c_up, c_down, c_lat, mask_f, x, K, halo,
                              *plan_tiles(x.shape[0], K))
    jacobi_bundle.launches += 1
    return out


jacobi_bundle.launches = 0


def jacobi_bundle_tiled(b, c_up, c_down, c_lat, mask_f, x, K: int, halo: int,
                        TI: int, S: int):
    """The tiled kernels with a given tile side TI and S sweeps on chip, on
    CUDA tensors; :func:`jacobi_bundle` calls it with :func:`plan_tiles`'
    choice (and counts the launch). Called directly only to compare tiles."""
    ptrs = _cuda_args(b, c_up, c_down, c_lat, mask_f, x, K, "jacobi_bundle")
    L, R, C = x.shape
    out = torch.empty_like(x)
    tmp = torch.empty_like(x)
    plane = torch.empty((R, C), dtype=torch.float32, device=x.device)
    partial = torch.empty(-(-R * C // NORM_THREADS), dtype=torch.float32,
                          device=x.device)
    norm = torch.empty((), dtype=torch.float32, device=x.device)
    live = torch.empty(-(-R // TI) * -(-C // TI), dtype=torch.uint8, device=x.device)
    _launch(_library().c3d_jacobi_bundle, "jacobi_bundle", x,
            [*ptrs, out.data_ptr(), tmp.data_ptr(), plane.data_ptr(),
             partial.data_ptr(), norm.data_ptr(), live.data_ptr(), L, R, C, K, halo,
             TI, S])
    return out, norm


def tiled_variant(b, c_up, c_down, c_lat, mask_f, x, K: int = SWEEPS_PER_BUNDLE) -> str:
    """Which tiled kernel :func:`jacobi_bundle` runs for these CUDA tensors:
    ``"resident"`` (coefficients in registers, tiles fetched by TMA while the
    previous one sweeps: L <= 7, C a multiple of 4, 16-byte aligned bases) or
    ``"generic"`` (coefficients in shared memory, staged by cp.async)."""
    L, _, C = x.shape
    ptrs = [t.data_ptr() for t in (b, c_up, c_down, c_lat, mask_f, x, x, x)]
    with torch.cuda.device(x.device):
        resident = _library().c3d_jacobi_bundle_resident(L, C, *plan_tiles(L, K), *ptrs)
    return "resident" if resident else "generic"


def jacobi_bundle_per_sweep(b, c_up, c_down, c_lat, mask_f, x,
                            K: int = SWEEPS_PER_BUNDLE, halo: int = 0):
    """The library's first design, one launch per sweep, on CUDA tensors
    only: the same function as :func:`jacobi_bundle`, bit for bit. It is
    kept to time and to hold the tiled design against; nothing on the main
    path calls it, and it counts no launches."""
    ptrs = _cuda_args(b, c_up, c_down, c_lat, mask_f, x, K, "jacobi_bundle_per_sweep")
    L, R, C = x.shape
    out = torch.empty_like(x)
    tmp = torch.empty_like(x)
    partial = torch.empty(-(-R * C // NORM_THREADS), dtype=torch.float32,
                          device=x.device)
    norm = torch.empty((), dtype=torch.float32, device=x.device)
    _launch(_library().c3d_jacobi_bundle_per_sweep, "jacobi_bundle_per_sweep", x,
            [*ptrs, out.data_ptr(), tmp.data_ptr(), partial.data_ptr(),
             norm.data_ptr(), L, R, C, K, halo])
    return out, norm


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

"""The CUDA kernels of the port against their plain PyTorch twins, and the
tiled bundled-Jacobi design against the per-sweep one, on the card. Every test here carries the ``cuda`` marker and skips where there is
no card; the file imports neither JAX nor the JAX package, so it runs on a
machine without them:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX.)
"""

import numpy as np
import pytest
import torch

from criteria3d_tpu_torch.solver import jacobi_bundle as TB
from criteria3d_tpu_torch.solver.shifts import LATERAL_OFFSETS


def seeded_system(shape, seed):
    """Seeded float32 bundle inputs with zero edge coefficients (c_up[0],
    c_down[L-1] and every lateral coefficient whose neighbour is missing
    or outside the box), as the assembly produces them."""
    rng = np.random.default_rng(seed)
    L, R, C = shape
    mask = rng.random(shape) < 0.9
    b = rng.uniform(-0.2, 0.2, shape) * mask
    up_ok = np.zeros(shape, bool)
    up_ok[1:] = mask[1:] & mask[:-1]
    dn_ok = np.zeros(shape, bool)
    dn_ok[:-1] = mask[:-1] & mask[1:]
    c_up = rng.uniform(0, 0.09, shape) * up_ok
    c_down = rng.uniform(0, 0.09, shape) * dn_ok
    c_lat = np.empty((8,) + shape)
    for k, (di, dj) in enumerate(LATERAL_OFFSETS):
        nb = np.zeros(shape, bool)
        rs = slice(max(di, 0), R + min(di, 0))
        rd = slice(max(-di, 0), R + min(-di, 0))
        cs = slice(max(dj, 0), C + min(dj, 0))
        cd = slice(max(-dj, 0), C + min(-dj, 0))
        nb[:, rd, cd] = mask[:, rs, cs]
        c_lat[k] = rng.uniform(0, 0.09, shape) * (mask & nb)
    x = rng.uniform(-3, 3, shape) * mask
    return tuple(a.astype(np.float32)
                 for a in (b, c_up, c_down, c_lat, mask.astype(np.float32), x))


def _cuda_arrays(shape, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel runs only on the card")
    return [torch.from_numpy(a).cuda() for a in seeded_system(shape, seed)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 37, 45), (7, 64, 96)])
def test_cuda_kernel_matches_plain_version(shape):
    """On the card: the CUDA kernel against its plain twin. The library is
    built with --fmad=false, so x is bit-equal; the norm is summed in
    another order (rel 1e-5)."""
    arrays = _cuda_arrays(shape, seed=5)
    before = TB.jacobi_bundle.launches
    xk, nk = TB.jacobi_bundle(*arrays)
    xp, np_ = TB.jacobi_bundle_reference(*arrays)
    torch.cuda.synchronize()
    assert TB.jacobi_bundle.launches == before + 1
    assert torch.equal(xk, xp)
    assert float(nk) == pytest.approx(float(np_), rel=1e-5)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_inputs():
    arrays = _cuda_arrays((3, 9, 7), seed=6)
    before = TB.jacobi_bundle.launches
    with pytest.raises(TypeError):
        TB.jacobi_bundle(arrays[0].double(), *arrays[1:])
    with pytest.raises(ValueError):
        TB.jacobi_bundle(*arrays[:3], arrays[3][:7], *arrays[4:])
    assert TB.jacobi_bundle.launches == before


def _extent(TI, where):
    return {"below": TI - 1, "at": 2 * TI, "past": 2 * TI + 1}[where]


@pytest.mark.cuda
@pytest.mark.parametrize("L,K,rows,cols,halo,masked", [
    (1, 1, "at", "at", 0, False),
    (1, 8, "past", "at", 8, True),
    (3, 3, "below", "below", 0, False),
    (3, 12, "at", "at", 0, True),
    (5, 5, "past", "at", 0, False),
    (7, 8, "at", "at", 0, False),
    (7, 8, "past", "below", 0, True),
    (7, 5, "past", "past", 8, False),
    (7, 12, "below", "at", 8, False),
    (11, 3, "at", "below", 8, False),
    (11, 12, "past", "at", 0, False),
    (24, 5, "past", "past", 0, False),
    (24, 8, "at", "past", 0, True),
])
def test_tiled_kernel_matches_plain_and_per_sweep(L, K, rows, cols, halo, masked):
    """The tiled design (the tile of plan_tiles for L and K; R and C below,
    at and one past a tile edge; K not a multiple of S; the halo mode; a
    box whose first tile is masked out, which the resident kernel skips and
    fills with +0.0) against the plain twin, x bit for
    bit and the norm to rel 1e-5 (summed in another order), and against
    the per-sweep design, x and norm bit for bit (the same per-column
    terms and the same fixed reduction tree). L <= 7 with C a multiple of 4
    runs the resident kernel, the rest the generic one."""
    TI, _ = TB.plan_tiles(L, K)
    shape = (L, _extent(TI, rows), _extent(TI, cols))
    arrays = _cuda_arrays(shape, seed=L * 100 + K)
    assert TB.tiled_variant(*arrays, K=K) == (
        "resident" if L <= 7 and shape[2] % 4 == 0 else "generic")
    if masked:   # only the mask: the plain version gives acc * 0, -0.0 where acc < 0
        arrays[4][..., :TI, :TI] = 0.0
    before = TB.jacobi_bundle.launches
    xk, nk = TB.jacobi_bundle(*arrays, K=K, halo=halo)
    xs, ns = TB.jacobi_bundle_per_sweep(*arrays, K=K, halo=halo)
    xp, np_ = TB.jacobi_bundle_reference(*arrays, K=K, halo=halo)
    torch.cuda.synchronize()
    assert TB.jacobi_bundle.launches == before + 1
    assert torch.equal(xk, xp)
    assert float(nk) == pytest.approx(float(np_), rel=1e-5)
    assert torch.equal(xk, xs) and torch.equal(nk, ns)


@pytest.mark.cuda
def test_cuda_kernel_halo_matches_plain_version():
    """halo = 8 at the CPU test's shape and seed (tests/test_torch_jacobi.py
    holds the twin against the Pallas halo mode there)."""
    arrays = _cuda_arrays((5, 37, 45), seed=7)
    xk, nk = TB.jacobi_bundle(*arrays, halo=8)
    xp, np_ = TB.jacobi_bundle_reference(*arrays, halo=8)
    torch.cuda.synchronize()
    assert torch.equal(xk, xp)
    assert float(nk) == pytest.approx(float(np_), rel=1e-5)

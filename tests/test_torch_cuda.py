"""The CUDA kernels of the port against their plain PyTorch twins, on the
card. Every test here carries the ``cuda`` marker and skips where there is
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

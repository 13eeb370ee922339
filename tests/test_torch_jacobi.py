"""The bundled Jacobi kernel's plain twin and the solve loop against the
JAX package's Pallas kernel (run in interpret mode on the CPU, as the JAX
package's own tests run it), plus the wrapper's checks. The CUDA kernel
itself is held against the plain twin in tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import criteria3d_tpu as J
from criteria3d_tpu.solver import pallas_jacobi as JP
from criteria3d_tpu.solver import water as JW
import criteria3d_tpu_torch as T
from criteria3d_tpu_torch.solver import jacobi_bundle as TB
from tests.test_catchment3d import valley_dem
from tests.test_torch_core import build_grids, rain_states
from tests.test_torch_cuda import seeded_system

torch.set_num_threads(1)

ULP = 2.0 ** -23


@pytest.mark.parametrize("shape", [(5, 37, 45), (11, 10, 10)])
def test_bundle_reference_matches_pallas(shape):
    """x to 4 ulp of max|x| (same sweeps and term order; XLA may contract
    a multiply-add); the norm to rel 1e-5 (f32 sums in another order)."""
    arrays = seeded_system(shape, seed=sum(shape))
    xj, nj = JP.jacobi_bundle(*(jnp.asarray(a) for a in arrays))
    xt, nt = TB.jacobi_bundle_reference(*(torch.from_numpy(a) for a in arrays))
    xj = np.asarray(xj)
    assert xt.dtype == torch.float32 and xt.shape == shape
    np.testing.assert_allclose(xt.numpy(), xj, rtol=0,
                               atol=4 * ULP * float(np.abs(xj).max()))
    assert float(nt) == pytest.approx(float(nj), rel=1e-5)


def test_wrapper_runs_plain_version_on_cpu():
    """On CPU tensors the wrapper IS the plain version and counts no
    kernel launch."""
    arrays = [torch.from_numpy(a) for a in seeded_system((3, 9, 7), seed=3)]
    before = TB.jacobi_bundle.launches
    x, n = TB.jacobi_bundle(*arrays, K=3)
    xr, nr = TB.jacobi_bundle_reference(*arrays, K=3)
    assert torch.equal(x, xr) and torch.equal(n, nr)
    assert TB.jacobi_bundle.launches == before


@pytest.mark.parametrize("fault", ["dtype", "shape", "contiguous"])
def test_wrapper_checks_reject_bad_inputs(fault):
    arrays = [torch.from_numpy(a) for a in seeded_system((3, 9, 7), seed=4)]
    if fault == "dtype":
        arrays[0] = arrays[0].double()
    elif fault == "shape":
        arrays[3] = arrays[3][:7]
    else:
        arrays[1] = arrays[1].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises((TypeError, ValueError)):
        TB._check(*arrays)


@pytest.mark.parametrize("case", [0, 1])
def test_solve_loop_matches_jax(case):
    """The port's host loop of bundles against the JAX while_loop on an
    assembled system: same n_it and divergence flag, x to rel 1e-5."""
    jp = J.SolverParameters.fast_f32(use_pallas=True)
    tp = T.SolverParameters.fast_f32(use_pallas=True)
    jg, tg = build_grids(valley_dem(12))
    js, _ = rain_states(jg, jp, tg, tp, psi0=-1.0 - case, rain_mm_h=20.0)
    psi = jnp.where(jg.mask, js.h - jg.z, 0.0).astype(jnp.float32)
    se = JW.compute_se_psi(jg, jp, psi)
    dt = 600.0 * (1 + case)
    system, *_ = JW.assemble_fast(jg, jp, psi, psi, se, js.sink_source,
                                  js.pond, jnp.asarray(0, jnp.int32),
                                  jnp.asarray(dt))
    mask_f = jg.mask.astype(jnp.float32)
    max_iter = jp.max_iterations_for(0)
    xj, dj, nj = JP.jacobi_solve_loop(system.b, system.c_up, system.c_down,
                                      system.c_lat, mask_f, psi, max_iter,
                                      1e-7, jg.n_nodes)
    t = [torch.from_numpy(np.array(a)) for a in
         (system.b, system.c_up, system.c_down, system.c_lat, mask_f, psi)]
    xt, dt_, nt = TB.jacobi_solve_loop(*t, tp.max_iterations_for(0), 1e-7,
                                       tg.n_nodes)
    assert nt == int(nj) and nt % TB.SWEEPS_PER_BUNDLE == 0
    assert dt_ == bool(dj)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-5,
                               atol=1e-5 * float(np.abs(np.asarray(xj)).max()))


def test_params_match_jax():
    """The preset and the per-approximation sweep cap (computed in
    float32) equal the JAX package's."""
    TP = T.SolverParameters
    for kw in ({}, dict(use_pallas=True), dict(inner_solver="jacobi"),
               dict(max_iterations=150, max_approximations=7)):
        jp, tp = J.SolverParameters.fast_f32(**kw), TP.fast_f32(**kw)
        for name in ("inner_solver", "cg_precond", "residual_tolerance",
                     "use_pallas", "mbr_threshold", "delta_t_max"):
            assert getattr(tp, name) == getattr(jp, name), (kw, name)
        for approx in range(10):
            assert tp.max_iterations_for(approx) == int(jp.max_iterations_for(approx))
    for acc in range(1, 6):
        jp, tp = (J.SolverParameters.from_model_accuracy(acc, 4.0),
                  TP.from_model_accuracy(acc, 4.0))
        for name in ("delta_t_min", "delta_t_max", "max_iterations",
                     "residual_tolerance", "mbr_threshold"):
            assert getattr(tp, name) == getattr(jp, name)

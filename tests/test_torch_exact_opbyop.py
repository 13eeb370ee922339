"""The port's float32 exact-mode coupled hour against the JAX package run
op by op (``jax.disable_jit()``) and jitted: the measurement behind the
5e-3 K bar of tests/test_torch_coupled.py::test_period_coupled_fast_matches_jax
(printed with ``pytest -s``). The float64 and frozen-props comparisons are
in tests/test_torch_coupled_opbyop.py.
"""

import numpy as np
import torch

import criteria3d_tpu as J
import criteria3d_tpu_torch as T
from tests.test_torch_coupled_opbyop import _heat_nodes, _hour

torch.set_num_threads(1)


def test_exact_fast_hour_matches_op_by_op():
    """fast_f32(heat_vapor=True) in exact mode on the 6 x 6 column for one
    hour: T within 2e-3 K and h within 1e-5 m of JAX run op by op. A
    float32 powf ulp in a per-sub-step theta moves where a sub-step's
    1e-5 K sweep stop lands; jitted JAX moves by more (printed)."""
    (jw, jh), (ew, eh), (tw, th), grid = _hour(
        J.SolverParameters.fast_f32(heat_vapor=True),
        T.SolverParameters.fast_f32(heat_vapor=True))
    m = _heat_nodes(grid)
    d_port = float(np.abs(th.t.numpy() - np.asarray(eh.t))[m].max())
    print(f"exact fast hour: port vs op-by-op JAX max|dT| {d_port} K; jitted "
          f"JAX vs op-by-op JAX "
          f"{np.abs(np.asarray(jh.t) - np.asarray(eh.t))[m].max()} K; port vs "
          f"jitted JAX {np.abs(th.t.numpy() - np.asarray(jh.t))[m].max()} K")
    assert d_port <= 2e-3
    np.testing.assert_allclose(tw.h.numpy(), np.asarray(ew.h), rtol=0, atol=1e-5)

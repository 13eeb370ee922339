"""The port's coupled paths against the JAX package run op by op
(``jax.disable_jit()``), the JAX semantics without XLA's jit rewrites
(divisions by constants folded into reciprocal multiplies, fused sums).

The float64 coupled step is bit-equal to it, and so are the temperatures
of the ``heat_frozen_props`` hour (its heads to a float32 ulp of psi: CG's
float64 dot products sum in another order). The float32 exact-mode hour is
in tests/test_torch_exact_opbyop.py. Each hour prints jitted JAX's
own distance from the op-by-op run (``pytest -s``), the
measurement behind the float32 bars of tests/test_torch_coupled.py.
"""

import dataclasses

import jax
import numpy as np
import torch

import criteria3d_tpu as J
from criteria3d_tpu.constants import ZEROCELSIUS
from criteria3d_tpu.solver import heat as JH
from criteria3d_tpu.solver.coupled import (compute_period_coupled as j_period,
                                           compute_step_coupled as j_step)
from criteria3d_tpu.solver.step import initialize_balance as j_ib
import criteria3d_tpu_torch as T
from tests.test_torch_core import port_grid, port_state
from tests.test_torch_coupled import jax_column, port_heat

torch.set_num_threads(1)


def _heat_nodes(grid):
    mask = np.asarray(grid.mask).copy()
    mask[0] = False
    return mask


def _hour(jp, tp, **column):
    """One coupled hour: JAX jitted, JAX op by op, the port; returns the
    three (water, heat) pairs and the grid."""
    grid, water, heat, boundary = jax_column(jp, **column)
    jit = j_period(grid, jp, water, heat, boundary, 3600.0)
    with jax.disable_jit():
        eager = j_period(grid, jp, water, heat, boundary, 3600.0)
    th, tb = port_heat(heat, boundary)
    port = T.compute_period_coupled(port_grid(grid), tp, port_state(water),
                                    th, tb, 3600.0)
    return jit, eager, port, grid


def test_coupled_step_f64_vapor_bit_equal_op_by_op():
    """One coupled step with vapor on tests/test_coupled.py's 4 x 4
    column, float64: h and T bit-equal to JAX run op by op."""
    dem = np.full((4, 4), 100.0)
    soil = J.SoilFields.uniform(dem.shape, vg_alpha=1.2, vg_n=1.5, vg_he=0.02,
                                theta_s=0.41, theta_r=0.04, k_sat=5e-6)
    grid = J.Grid.build(dem, 2.0, soil, total_depth=0.5,
                        free_catchment_runoff=False)
    jp = J.SolverParameters(heat_vapor=True)
    tp = T.SolverParameters(heat_vapor=True)
    water = j_ib(grid, jp, J.WaterState.initialize(grid, jp, matric_potential=-1.0))
    heat = JH.initialize_heat(grid, ZEROCELSIUS + 10.0)
    heat = dataclasses.replace(heat, storage_prev=JH.heat_storage(grid, jp, heat, water))
    boundary = JH.HeatBoundary.uniform(grid.shape[1:],
                                       air_temperature=ZEROCELSIUS + 25.0,
                                       net_irradiance=400.0)
    with jax.disable_jit():
        jw, jh, jdt = j_step(grid, jp, water, heat, boundary, 3600.0)
    th, tb = port_heat(heat, boundary)
    tw, tht, tdt = T.compute_step_coupled(port_grid(grid), tp, port_state(water),
                                          th, tb, 3600.0)
    assert tdt == float(jdt)
    np.testing.assert_array_equal(tw.h.numpy(), np.asarray(jw.h))
    np.testing.assert_array_equal(tht.t.numpy(), np.asarray(jh.t))


def test_frozen_props_hour_bit_equal_op_by_op():
    """fast_f32(heat_vapor=True, heat_frozen_props=True) on the 1 x 1
    column for one hour: T bit-equal to JAX run op by op, h within 1e-6 m
    (a float32 ulp of psi is 2.4e-7 m here)."""
    kw = dict(heat_vapor=True, heat_frozen_props=True)
    (jw, jh), (ew, eh), (tw, th), grid = _hour(
        J.SolverParameters.fast_f32(**kw), T.SolverParameters.fast_f32(**kw),
        n=1, total_depth=0.8, mask_all=True)
    m = _heat_nodes(grid)
    print(f"frozen props hour: jitted JAX vs op-by-op JAX max|dT| "
          f"{np.abs(np.asarray(jh.t) - np.asarray(eh.t))[m].max()} K")
    np.testing.assert_allclose(tw.h.numpy(), np.asarray(ew.h), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(th.t.numpy(), np.asarray(eh.t))

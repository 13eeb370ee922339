"""One coupled water + heat hour of the port's model cycle
(``ModelConfig(compute_heat=True)``) against the JAX package's, on the
valley of tests/test_torch_model.py with every layer-1 node a HeatSurface.

Tolerance: T within 5e-3 K and heads within 1e-4 m, as
tests/test_torch_coupled.py holds float32 coupled hours (the spread of
jitted JAX against itself, PERF.md section 2).
"""

import numpy as np
import pytest
import torch

import criteria3d_tpu as J
import criteria3d_tpu_torch as T
from tests.test_torch_model import DATE, forcing, models

torch.set_num_threads(1)


def test_heat_hour_matches_jax():
    """One compute_heat hour (fast_f32 with heat_frozen_props and vapor,
    every layer-1 node a HeatSurface): T within 5e-3 K, heads within
    1e-4 m, the soil temperature output on the CPU, the hour-start
    HeatSurface evaporation estimate rel 1e-9."""
    kw = dict(heat_vapor=True, heat_frozen_props=True)
    jm, tm = models(J.SolverParameters.fast_f32(**kw),
                    T.SolverParameters.fast_f32(**kw), heat=True, n=8)
    jf, tf = forcing(tm.grid, 10)
    jo = jm.run_hour(jf, DATE.year, DATE.month, DATE.day, 10)
    to = tm.run_hour(tf, DATE.year, DATE.month, DATE.day, 10)
    dT = float(np.abs(np.asarray(jm.heat.t) - tm.heat.t.numpy()).max())
    dh = float(np.abs(np.asarray(jm.water.h) - tm.water.h.numpy()).max())
    assert dT < 5e-3 and dh < 1e-4, (dT, dh)
    assert to["soil_temperature"] is tm.heat.t
    assert float(to["heat_surface_evaporation_m3s"]) == pytest.approx(
        float(jo["heat_surface_evaporation_m3s"]), rel=1e-9)

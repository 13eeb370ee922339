"""criteria3d_tpu_torch — the PyTorch and CUDA port of criteria3d_tpu.

The JAX package ``criteria3d_tpu`` is the reference; this package computes
the same functions with PyTorch tensors and hand-written CUDA kernels for an
NVIDIA Hopper card (sm_90a). It imports neither JAX nor anything of the JAX
package.

Ported so far: the water-only simulated hour of the float32 psi-carry preset
with the bundled Jacobi inner solver,
``SolverParameters.fast_f32(use_pallas=True)``. Its inner solve runs the
CUDA kernel ``csrc/jacobi_bundle.cu`` on CUDA tensors and its plain PyTorch
twin on CPU tensors.
"""

from criteria3d_tpu_torch.core.soil import MeanType, SoilFields, WRCModel
from criteria3d_tpu_torch.core.grid import BoundaryType, Grid
from criteria3d_tpu_torch.core.state import (BalanceData, SolverParameters,
                                             WaterState)
from criteria3d_tpu_torch.solver.step import (compute_period,
                                              compute_period_stats,
                                              compute_step,
                                              initialize_balance)

__all__ = [
    "SoilFields", "WRCModel", "MeanType", "Grid", "BoundaryType",
    "WaterState", "BalanceData", "SolverParameters", "compute_step",
    "compute_period", "compute_period_stats", "initialize_balance",
]

"""criteria3d_tpu_torch — the PyTorch and CUDA port of criteria3d_tpu.

The JAX package ``criteria3d_tpu`` is the reference; this package computes
the same functions with PyTorch tensors and hand-written CUDA kernels for an
NVIDIA Hopper card (sm_90a). It imports neither JAX nor anything of the JAX
package.

Ported: the water solver -- the float64 parity path
(``SolverParameters()``), the float32 psi-carry path with CG and the line
preconditioner (``SolverParameters.fast_f32()``) or the bundled Jacobi
kernel (``fast_f32(use_pallas=True)``), and per-link flow accounting; soil
heat and the coupled water + heat step (``solver/heat.py``,
``solver/coupled.py``); the hourly model cycle (``model.py``: radiation,
snow, ET0, interception, cracking and crop from ``physics/``, the HYDRALL
forest model and RothC soil carbon) with its state checkpoints (``io/``);
the project stack (``project.py``, with the water table, the meteo grid
DB, the native raster writer pool and the HTML report); the VINE3D model
and project (``vine3d.py``, ``vine3d_project.py``: grapevine physiology
and the two mildews); the command shell (``cli.py``: ``python -m
criteria3d_tpu_torch.cli script.txt``) with its GeoTIFF, quick-look and
``viz/`` renderers; the interpolation library and the side library; the
device mesh (``parallel/sharding.py``: the bundled-Jacobi loop on the
blocks of a ('row', 'col') mesh of devices). The bundled Jacobi solve runs
the CUDA kernel ``csrc/jacobi_bundle.cu`` on CUDA tensors and its plain
PyTorch twin on CPU tensors.
"""

__version__ = "0.1.0"

from criteria3d_tpu_torch.core.soil import MeanType, SoilFields, WRCModel
from criteria3d_tpu_torch.core.grid import BoundaryType, Grid
from criteria3d_tpu_torch.core.state import (BalanceData, SolverParameters,
                                             WaterState)
from criteria3d_tpu_torch.model import (Criteria3DModel, HourlyForcing,
                                        ModelConfig)
from criteria3d_tpu_torch.solver.coupled import (compute_period_coupled,
                                                 compute_step_coupled)
from criteria3d_tpu_torch.solver.heat import (HeatBoundary, HeatState,
                                              heat_storage, initialize_heat)
from criteria3d_tpu_torch.solver.step import (compute_period,
                                              compute_period_stats,
                                              compute_step,
                                              initialize_balance)

__all__ = [
    "SoilFields", "WRCModel", "MeanType", "Grid", "BoundaryType",
    "WaterState", "BalanceData", "SolverParameters", "compute_step",
    "compute_period", "compute_period_stats", "initialize_balance",
    "HeatState", "HeatBoundary", "initialize_heat", "heat_storage",
    "compute_step_coupled", "compute_period_coupled",
    "Criteria3DModel", "HourlyForcing", "ModelConfig",
]

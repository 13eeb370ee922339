"""Prognostic state, balance bookkeeping and solver parameters.

PyTorch counterpart of ``criteria3d_tpu/core/state.py`` (the reference's
waterData_t / balanceData_t / SolverParameters, types.h:137-184, 291-315).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference.core.grid import Grid
from benchmark.reference.core.soil import (MeanType, WRCModel,
                                            mualem_conductivity, se_from_psi)
from benchmark.reference.device import resolve_device

__all__ = ["SolverParameters", "BalanceData", "WaterState"]


@dataclasses.dataclass(frozen=True)
class SolverParameters:
    """Numerical parameters (reference types.h:291-315,
    project3D.cpp:619-652), with torch dtypes. The reference runs the
    float32 psi-carry step (the ``fast_f32()`` preset: CG with the
    vertical-line preconditioner), coupled to soil heat with the
    ``heat_*`` fields.
    """

    mbr_threshold: float = 1e-3
    residual_tolerance: float = 1e-10
    delta_t_min: float = 1.0
    delta_t_max: float = 600.0
    max_approximations: int = 10
    max_iterations: int = 200
    wrc_model: WRCModel = WRCModel.MODIFIED_VAN_GENUCHTEN
    mean_type: MeanType = MeanType.LOGARITHMIC
    lateral_vertical_ratio: float = 4.0
    heat_weight_factor: float = 0.5
    heat_vapor: bool = False
    heat_advection: bool = False
    heat_frozen_props: bool = False
    courant_threshold: float = 0.5     # dt growth gate
    instability_factor: float = 10.0
    # the reference's integer-abs truncation of the surface-Courant head
    # difference (water.cpp:477); see the JAX package's SolverParameters
    courant_reference_compat: bool = True
    # the reference's culvert water level 0.5*(H - Hold) - z (water.cpp:760)
    culvert_reference_compat: bool = True
    dtype: torch.dtype = torch.float64
    # inner solve precision; float32 = the psi-carry fast path
    sweep_dtype: torch.dtype | None = None

    def max_iterations_for(self, approx: int) -> int:
        """(approx+1) * maxIter/maxApprox, min 25 (solver.h:55-59),
        computed in float32 as the JAX package does."""
        per = np.float32(self.max_iterations) / np.float32(self.max_approximations)
        n = int(np.float32(approx + 1) * per)
        return max(n, 25)

    @staticmethod
    def fast_f32(**overrides) -> "SolverParameters":
        """Mixed-precision preset: the f32 psi-carry production path, its
        inner solver CG with the vertical-line preconditioner; residual
        tolerance 1e-7."""
        args = dict(sweep_dtype=torch.float32, residual_tolerance=1e-7)
        args.update(overrides)
        return SolverParameters(**args)


@dataclasses.dataclass(frozen=True, eq=False)
class BalanceData:
    """Scalar mass-balance bookkeeping (balanceData_t, types.h:175-184);
    0-d tensors."""

    storage: torch.Tensor          # [m3]
    sink_source: torch.Tensor      # [m3]
    mbe: torch.Tensor              # [m3]
    mbr: torch.Tensor              # [-]

    @staticmethod
    def zero(dtype=torch.float64, device=None) -> "BalanceData":
        z = torch.zeros((), dtype=dtype, device=resolve_device(device))
        return BalanceData(z, z, z, z)


@dataclasses.dataclass(frozen=True, eq=False)
class WaterState:
    """Evolving water state. Field tensors are (L, R, C); ``h`` is the
    TOTAL hydraulic potential [m] (z + matric potential). The solver never
    writes into these tensors: every step builds new ones."""

    h: torch.Tensor                 # [m] total potential
    h_old: torch.Tensor             # [m] previous accepted step
    best_h: torch.Tensor            # [m] best Picard iterate of current step
    se: torch.Tensor                # [-] degree of saturation
    k: torch.Tensor                 # [m s-1] hydraulic conductivity
    sink_source: torch.Tensor       # [m3 s-1] user-set water sink/source
    pond: torch.Tensor              # (R,C) [m] surface pond storage height
    boundary_flow_sum: torch.Tensor  # (L,R,C) [m3] cumulated boundary flow
    link_flow_sum: torch.Tensor     # (0,): per-link flows are not tracked

    dt_curr: torch.Tensor           # [s] adaptive time step (persistent)
    courant: torch.Tensor           # [-] last surface Courant number

    balance_prev: BalanceData
    balance_current: BalanceData
    balance_period: BalanceData
    balance_whole: BalanceData

    @staticmethod
    def initialize(grid: Grid, params: SolverParameters, *,
                   matric_potential, surface_water: float = 0.0,
                   device=None) -> "WaterState":
        """Initial state from matric potential [m] (setNodeMatricPotential,
        soilFluxes3D.cpp:842-884). ``device=None`` means the CUDA card; the
        grid must already live on that device."""
        dev = resolve_device(device)
        if grid.device != dev and not (dev.index is None
                                       and grid.device.type == dev.type):
            raise ValueError(f"the grid lives on {grid.device}, not on {dev}; "
                             "move it with grid.to(device)")
        dev = grid.device
        dt = params.dtype
        L, R, C = grid.shape
        psi = torch.broadcast_to(
            torch.as_tensor(matric_potential, dtype=dt, device=dev), (L, R, C))
        h = grid.z + psi
        h[0] = grid.z[0] + torch.clamp_min(psi[0], surface_water)
        psi_mag = torch.abs(torch.clamp_max(h - grid.z, 0.0))
        se = torch.where(h >= grid.z, 1.0,
                         se_from_psi(grid.soil, psi_mag, params.wrc_model))

        se = se.clone()
        se[0] = 1.0
        se = torch.where(grid.mask, se, 0.0)
        h = torch.where(grid.mask, h, 0.0)
        k = torch.where(grid.mask,
                        mualem_conductivity(grid.soil, se, params.wrc_model),
                        0.0)
        k[0] = 0.0

        link0 = torch.zeros((0,), dtype=dt, device=dev)
        bal = BalanceData.zero(dt, dev)
        return WaterState(
            h=h, h_old=h, best_h=h, se=se, k=k,
            sink_source=torch.zeros((L, R, C), dtype=dt, device=dev),
            pond=grid.pond_max.to(dt),
            boundary_flow_sum=torch.zeros((L, R, C), dtype=dt, device=dev),
            link_flow_sum=link0,
            dt_curr=torch.full((), params.delta_t_max, dtype=dt, device=dev),
            courant=torch.zeros((), dtype=dt, device=dev),
            balance_prev=bal, balance_current=bal,
            balance_period=bal, balance_whole=bal,
        )

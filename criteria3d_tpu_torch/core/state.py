"""Prognostic state, balance bookkeeping and solver parameters.

PyTorch counterpart of ``criteria3d_tpu/core/state.py`` (the reference's
waterData_t / balanceData_t / SolverParameters, types.h:137-184, 291-315).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from criteria3d_tpu_torch.core.grid import Grid
from criteria3d_tpu_torch.core.soil import (MeanType, WRCModel,
                                            mualem_conductivity, psi_from_se,
                                            se_from_psi)
from criteria3d_tpu_torch.device import map_tensors, resolve_device

__all__ = ["SolverParameters", "BalanceData", "WaterState"]


@dataclasses.dataclass(frozen=True)
class SolverParameters:
    """Numerical parameters (reference types.h:291-315,
    project3D.cpp:619-652); the same fields and defaults as the JAX
    package's, with torch dtypes and without its device ``mesh``.

    The port runs one configuration so far, the float32 psi-carry preset
    with the bundled Jacobi solver, ``fast_f32(use_pallas=True)``, and the
    per-sweep float32 Jacobi solver (``fast_f32(inner_solver="jacobi")``).
    The solver raises ``NotImplementedError`` for the others (see
    ``criteria3d_tpu_torch.solver.step.check_supported``).
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
    track_link_flow: bool = False
    # the reference's culvert water level 0.5*(H - Hold) - z (water.cpp:760)
    culvert_reference_compat: bool = True
    dtype: torch.dtype = torch.float64
    # inner solve precision; float32 = the psi-carry fast path
    sweep_dtype: torch.dtype | None = None
    # bundled Jacobi sweeps (K per call, convergence checked every K):
    # the CUDA kernel csrc/jacobi_bundle.cu on the card
    use_pallas: bool = False
    inner_solver: str = "jacobi"
    cg_precond: str = "diag"

    def max_iterations_for(self, approx: int) -> int:
        """(approx+1) * maxIter/maxApprox, min 25 (solver.h:55-59),
        computed in float32 as the JAX package does."""
        per = np.float32(self.max_iterations) / np.float32(self.max_approximations)
        n = int(np.float32(approx + 1) * per)
        return max(n, 25)

    @staticmethod
    def fast_f32(**overrides) -> "SolverParameters":
        """Mixed-precision preset: the f32 psi-carry production path.

        Residual tolerance 1e-7; the inner solver is CG with the
        vertical-line preconditioner unless the caller asks for the bundled
        Jacobi kernel (``use_pallas=True``) or sets ``inner_solver``,
        exactly as in the JAX package."""
        args = dict(sweep_dtype=torch.float32, residual_tolerance=1e-7)
        if not overrides.get("use_pallas", False) \
                and "inner_solver" not in overrides:
            args["inner_solver"] = "cg"
            args.setdefault("cg_precond", "line")
        args.update(overrides)
        return SolverParameters(**args)

    @staticmethod
    def from_model_accuracy(accuracy: int, cell_size: float) -> "SolverParameters":
        """App-level accuracy 1-5 -> numerical parameters
        (Project3D::setAccuracy, project3D.cpp:619-652)."""
        v_max = 5.0 + 5.0 * accuracy
        return SolverParameters(
            delta_t_min=min(6.0, cell_size / v_max),
            delta_t_max=3600.0,
            max_iterations=150,
            max_approximations=10,
            residual_tolerance=10.0 ** -(7 + accuracy),
            mbr_threshold=10.0 ** -accuracy,
        )


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

    def to(self, device) -> "BalanceData":
        return map_tensors(self, lambda t: t.to(device))


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
    link_flow_sum: torch.Tensor     # (10,L,R,C) or (0,) when not tracked

    dt_curr: torch.Tensor           # [s] adaptive time step (persistent)
    courant: torch.Tensor           # [-] last surface Courant number

    balance_prev: BalanceData
    balance_current: BalanceData
    balance_period: BalanceData
    balance_whole: BalanceData

    def to(self, device) -> "WaterState":
        return map_tensors(self, lambda t: t.to(device))

    @staticmethod
    def initialize(grid: Grid, params: SolverParameters, *,
                   matric_potential=None, degree_of_saturation=None,
                   surface_water: float = 0.0, device=None) -> "WaterState":
        """Initial state from matric potential [m] or saturation degree
        (setNodeMatricPotential / setNodeDegreeOfSaturation,
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
        if matric_potential is not None:
            psi = torch.broadcast_to(
                torch.as_tensor(matric_potential, dtype=dt, device=dev),
                (L, R, C))
            h = grid.z + psi
            h[0] = grid.z[0] + torch.clamp_min(psi[0], surface_water)
            psi_mag = torch.abs(torch.clamp_max(h - grid.z, 0.0))
            se = torch.where(h >= grid.z, 1.0,
                             se_from_psi(grid.soil, psi_mag, params.wrc_model))
        elif degree_of_saturation is not None:
            se = torch.broadcast_to(
                torch.as_tensor(degree_of_saturation, dtype=dt, device=dev),
                (L, R, C))
            psi = psi_from_se(grid.soil, torch.clamp(se, 1e-9, 1.0),
                              params.wrc_model)
            h = grid.z - psi
            h[0] = grid.z[0] + surface_water
        else:
            raise ValueError("give matric_potential or degree_of_saturation")

        se = se.clone()
        se[0] = 1.0
        se = torch.where(grid.mask, se, 0.0)
        h = torch.where(grid.mask, h, 0.0)
        k = torch.where(grid.mask,
                        mualem_conductivity(grid.soil, se, params.wrc_model),
                        0.0)
        k[0] = 0.0

        link0 = (torch.zeros((10, L, R, C), dtype=dt, device=dev)
                 if params.track_link_flow
                 else torch.zeros((0,), dtype=dt, device=dev))
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

    # convenience diagnostics -------------------------------------------------
    def matric_potential(self, grid: Grid) -> torch.Tensor:
        return torch.where(grid.mask, self.h - grid.z, 0.0)

    def surface_water_level(self, grid: Grid) -> torch.Tensor:
        return torch.where(grid.mask[0],
                           torch.clamp_min(self.h[0] - grid.z[0], 0.0), 0.0)

"""Per-link cumulative water-flow getters.

PyTorch counterpart of ``criteria3d_tpu/solver/link_flows.py``, the
reference's link-flow API (soilFluxes3D.cpp:1126-1216) vectorized: each
getter returns the full (L, R, C) map instead of one node's scalar. Needs
``SolverParameters.track_link_flow=True``, so that
``WaterState.link_flow_sum`` (10, L, R, C) is populated: slots 0 = up,
1 = down, 2..9 = the 8 lateral directions; positive = inflow [m3]. On a
state partitioned over a mesh each getter returns its map per block
(``gather_pytree`` joins it); the sums are exact on the cells each block
owns.
"""

from __future__ import annotations

import torch

from criteria3d_tpu_torch.core.state import WaterState
from criteria3d_tpu_torch.parallel.sharding import bmap, first_block

__all__ = ["up_flow", "down_flow", "max_lateral_flow", "sum_lateral_flow",
           "sum_lateral_flow_in", "sum_lateral_flow_out"]


def _require(state: WaterState):
    if first_block(state.link_flow_sum).ndim != 4:
        raise ValueError(
            "link flows not tracked: set SolverParameters.track_link_flow")
    return state.link_flow_sum


def up_flow(state: WaterState) -> torch.Tensor:
    """Cumulative flow through each node's UP link [m3]
    (getNodeMaxWaterFlow(Up), soilFluxes3D.cpp:1137-1141)."""
    return bmap(lambda lf: lf[0], _require(state))


def down_flow(state: WaterState) -> torch.Tensor:
    """Cumulative flow through each node's DOWN link [m3]
    (getNodeMaxWaterFlow(Down), soilFluxes3D.cpp:1142-1146)."""
    return bmap(lambda lf: lf[1], _require(state))


def max_lateral_flow(state: WaterState) -> torch.Tensor:
    """Max over the 8 lateral links, floored at 0
    (getNodeMaxWaterFlow(Lateral), soilFluxes3D.cpp:1147-1152)."""
    return bmap(lambda lf: torch.clamp_min(lf[2:].amax(dim=0), 0.0), _require(state))


def sum_lateral_flow(state: WaterState) -> torch.Tensor:
    """Net lateral exchange per node [m3]
    (getNodeSumLateralWaterFlow, soilFluxes3D.cpp:1162-1176)."""
    return bmap(lambda lf: lf[2:].sum(dim=0), _require(state))


def sum_lateral_flow_in(state: WaterState) -> torch.Tensor:
    """Total lateral inflow (positive link sums only)
    (getNodeSumLateralWaterFlowIn, soilFluxes3D.cpp:1182-1196)."""
    return bmap(lambda lf: torch.clamp_min(lf[2:], 0.0).sum(dim=0), _require(state))


def sum_lateral_flow_out(state: WaterState) -> torch.Tensor:
    """Total lateral outflow (negative link sums only)
    (getNodeSumLateralWaterFlowOut, soilFluxes3D.cpp:1202-1216)."""
    return bmap(lambda lf: torch.clamp_max(lf[2:], 0.0).sum(dim=0), _require(state))

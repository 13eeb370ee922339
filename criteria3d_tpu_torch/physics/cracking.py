"""Soil-cracking preferential flow.

PyTorch counterpart of ``criteria3d_tpu/physics/cracking.py``
(Crit3DProject::computeSoilCracking, criteria3DProject.cpp:969-1113): in
fine-textured dry soils part of the precipitation bypasses the matrix
through shrinkage cracks, filling the profile's void volume from the bottom
of the crack upward; the remainder stays on the surface.
"""

from __future__ import annotations

import numpy as np
import torch

from criteria3d_tpu_torch.core.grid import Grid
from criteria3d_tpu_torch.core.soil import theta_from_se
from criteria3d_tpu_torch.core.state import SolverParameters
from criteria3d_tpu_torch.ops import div, where

__all__ = ["soil_cracking"]

MAX_CRACKING_DEPTH = 0.6       # [m]
MIN_FINE_LAYER_DEPTH = 0.2     # [m]
MIN_VOID_VOLUME = 0.15         # [m3 m-3]
MAX_VOID_VOLUME = 0.20
MIN_FINE_FRACTION = 0.5
MAX_STORAGE = 0.05             # [m3 m-3]


def soil_cracking(grid: Grid, params: SolverParameters, se, precipitation_mm,
                  pond_mm, *, fine_fraction=None):
    """(crack_sink [m3 s-1] (L,R,C) float64, residual_surface_water [mm]
    (R,C)).

    ``fine_fraction``: (R,C) clay+silt/2 fraction of the profile; cells below
    MIN_FINE_FRACTION never crack. Defaults to 0.6 (cracking-prone)."""
    L, R, C = grid.shape
    dev = grid.device
    prec = precipitation_mm.to(torch.float64)
    if fine_fraction is None:
        fine_fraction = torch.full((R, C), 0.6, dtype=torch.float64, device=dev)

    depths = np.asarray(grid.layer_depth)
    thicks = np.asarray(grid.layer_thickness)
    soil_depth = depths[-1] + thicks[-1] * 0.5
    max_depth = min(soil_depth, MAX_CRACKING_DEPTH)

    # crackable layers: centre depth within the fine horizon span
    in_crack = np.zeros(L, bool)
    for l in range(1, L):
        in_crack[l] = depths[l] <= max_depth
    in_crack_t = torch.tensor(in_crack, device=dev).reshape(L, 1, 1)
    thick_t = torch.tensor(thicks, dtype=torch.float64, device=dev).reshape(L, 1, 1)

    theta = theta_from_se(grid.soil, se)
    void = torch.clamp_min(grid.soil.theta_s - theta, 0.0)
    void = where(in_crack_t & grid.mask, void, 0.0)

    crack_depth = torch.sum(torch.where(in_crack_t & grid.mask, thick_t, 0.0),
                            dim=0)
    void_sum = torch.sum(void * thick_t, dim=0)
    avg_void = void_sum / torch.clamp_min(crack_depth, 1e-9)

    cracked = (prec > pond_mm) \
        & (fine_fraction >= MIN_FINE_FRACTION) \
        & (avg_void > MIN_VOID_VOLUME) \
        & (crack_depth > 0) \
        & bool(soil_depth > MIN_FINE_LAYER_DEPTH)

    crack_ratio = torch.clamp(div(avg_void - MIN_VOID_VOLUME,
                                  MAX_VOID_VOLUME - MIN_VOID_VOLUME), 0.0, 1.0)
    max_infiltration = prec * crack_ratio
    surface_water = torch.maximum(prec - max_infiltration, pond_mm)
    potential = where(cracked, torch.clamp_min(prec - surface_water, 0.0), 0.0)

    # fill from the bottom of the crack upward (criteria3DProject.cpp:1085-1109)
    storage_mm = torch.clamp_max(void, MAX_STORAGE) * thick_t * 1000.0   # [mm]
    residual = potential
    sink = torch.zeros((L, R, C), dtype=torch.float64, device=dev)
    for l in range(L - 1, 0, -1):
        if not in_crack[l]:
            continue
        take = torch.minimum(storage_mm[l], residual)
        take = where(cracked & grid.mask[l], take, 0.0)
        residual = residual - take
        sink[l] = div(div(grid.area * take, 1000.0), 3600.0)

    residual_surface = torch.where(cracked, surface_water + residual, prec)
    return sink, residual_surface

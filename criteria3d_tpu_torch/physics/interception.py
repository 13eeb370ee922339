"""Canopy rainfall interception (Van Dijk & Bruijnzeel 2001).

PyTorch counterpart of ``criteria3d_tpu/physics/interception.py``
(agrolib/crop/rainfallInterception.cpp, namespace canopy): per-cell canopy
water storage balance with free throughfall, interception, canopy
evaporation, drainage and stemflow. All quantities in [mm] per time step;
tensors of any shape.
"""

from __future__ import annotations

import torch

__all__ = ["canopy_water_management", "plant_cover", "storage_capacity",
           "hydrall_interception"]


def plant_cover(lai, extinction_coefficient=0.6, lai_min=0.2):
    """Fraction of ground covered (rainfallInterception.cpp:27-31)."""
    lai = torch.clamp_min(lai, lai_min)
    return 1.0 - torch.exp(-extinction_coefficient * lai)


def storage_capacity(lai, leaf_storage=0.2, stem_storage=0.5):
    """[mm] canopy storage capacity (rainfallInterception.cpp:33-36)."""
    return leaf_storage * lai + stem_storage


def hydrall_interception(lai_canopy, lai_understorey, prec):
    """HYDRALL variant: interception [mm] (rainfallInterception.cpp:10-19)."""
    max_interception = 0.15 * torch.clamp_max(prec, 20.0)
    canopy_capacity = 0.07 * (lai_canopy + lai_understorey)
    return torch.minimum(canopy_capacity, max_interception)


def canopy_water_management(stored_water, rainfall, free_evaporation, lai,
                            *, lai_min=0.2, extinction_coefficient=0.6,
                            leaf_storage=0.2, stem_storage=0.5,
                            max_stem_flow_rate=0.15):
    """One step of the canopy water balance (waterManagementCanopy,
    rainfallInterception.cpp:75-116).

    Returns a dict with ``stored_water`` (new state), ``soil_water`` (rain
    reaching the ground), ``free_rainfall``, ``drainage``, ``stem_flow``,
    ``throughfall`` and ``canopy_evaporation``."""
    cover = plant_cover(lai, extinction_coefficient, lai_min)
    capacity = storage_capacity(lai, leaf_storage, stem_storage)

    free_rain = rainfall * (1.0 - cover)
    interception = rainfall * cover
    gross = stored_water + interception

    # evaporation from canopy (rainfallInterception.cpp:47-60)
    evap = torch.where(gross < 0.01 * capacity, gross,
                       torch.where(gross >= capacity, free_evaporation,
                                   free_evaporation * gross
                                   / torch.clamp_min(capacity, 1e-9)))
    evap = torch.minimum(evap, gross)
    gross = gross - evap

    drainage = torch.clamp_min(gross - capacity, 0.0)
    stem_flow = drainage * max_stem_flow_rate
    soil_water = free_rain + drainage
    throughfall = soil_water - stem_flow
    stored = gross - drainage

    return dict(stored_water=stored, soil_water=soil_water,
                free_rainfall=free_rain, drainage=drainage,
                stem_flow=stem_flow, throughfall=throughfall,
                canopy_evaporation=evap)

"""The psychrometric functions the soil heat solve reads (a copy of the
port's ``physics/meteo.py`` at 988b1ed, the five it needs)."""

from __future__ import annotations

import torch

from benchmark.reference.constants import GRAVITY
from benchmark.reference.core.soil import power
from benchmark.reference.ops import div

# physics.cpp / commonConstants.h values
P0 = 101325.0              # [Pa] sea-level standard pressure
TP0 = 293.16               # [K]
LAPSE_RATE_MOIST_AIR = 0.0065   # [K m-1]
R_DRY_AIR = 287.058        # [J kg-1 K-1]
R_GAS = 8.31447215         # [J K-1 mol-1]


def saturation_vapor_pressure(t_celsius):
    """[Pa] Tetens form (physics.cpp:118-121)."""
    return 611.0 * torch.exp(17.502 * t_celsius / (t_celsius + 240.97))


def pressure_from_altitude(height_m):
    """[Pa] barometric pressure (Allen et al. 1994; physics.cpp:39-47)."""
    return P0 * power(1.0 + div(height_m * LAPSE_RATE_MOIST_AIR, TP0),
                      -GRAVITY / (LAPSE_RATE_MOIST_AIR * R_DRY_AIR))


def latent_heat_vaporization(t_celsius):
    """[J kg-1] (physics.cpp:149-152)."""
    return 2501000.0 - 2369.2 * t_celsius


def vapor_concentration_from_pressure(vp_pa, t_kelvin):
    """[kg m-3] vapor concentration from partial pressure (physics.cpp)."""
    return vp_pa * 0.018 / (R_GAS * t_kelvin)

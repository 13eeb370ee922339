"""Psychrometrics and reference evapotranspiration (ET0).

PyTorch counterpart of ``criteria3d_tpu/physics/meteo.py`` (the reference's
agrolib/mathFunctions/physics.cpp helpers and the ET0 formulas of
agrolib/meteo/meteo.cpp:469-700): Penman-Monteith hourly (CIMIS form) and
daily, Hargreaves daily, and the daily index helpers. Every function is
element-wise on tensors of any shape and evaluates the same expressions, in
the same order, as its JAX twin (the float rules of ``ops.py``).
"""

from __future__ import annotations

import math

import torch

from criteria3d_tpu_torch.constants import (GRAVITY, HOUR_SECONDS,
                                            STEFAN_BOLTZMANN, ZEROCELSIUS)
from criteria3d_tpu_torch.core.soil import power
from criteria3d_tpu_torch.ops import as_f64, div, ipow, rdiv, sq, where

__all__ = [
    "saturation_vapor_pressure", "saturation_slope", "pressure_from_altitude",
    "latent_heat_vaporization", "psychrometric_constant", "air_density",
    "vapor_concentration_from_pressure", "et0_penman_hourly",
    "et0_hargreaves_daily", "dew_point_from_rh", "rh_from_dew_point",
    "emissivity_from_vapor_pressure", "atmospheric_emissivity_brutsaert",
    "daily_extraterrestrial_radiation", "thom_index", "daily_bic",
    "daily_thermal_range", "heating_degree_days", "cooling_degree_days",
    "wind_cartesian", "wind_polar", "et0_penman_daily",
    "et0_penman_hourly_net_rad",
]

# physics.cpp / commonConstants.h values
P0 = 101325.0              # [Pa] sea-level standard pressure
TP0 = 293.16               # [K]
LAPSE_RATE_MOIST_AIR = 0.0065   # [K m-1]
R_DRY_AIR = 287.058        # [J kg-1 K-1]
R_GAS = 8.31447215         # [J K-1 mol-1]
M_AIR = 0.029              # [kg mol-1]
CP = 1013.0                # [J kg-1 K-1] specific heat of moist air
RATIO_WATER_VD = 0.622
ALBEDO_CROP_REFERENCE = 0.23

SOLAR_CONSTANT = 1367.0   # [W m-2]
DAY_SECONDS = 86400.0


def saturation_vapor_pressure(t_celsius):
    """[Pa] Tetens form (physics.cpp:118-121)."""
    return 611.0 * torch.exp(17.502 * t_celsius / (t_celsius + 240.97))


def saturation_slope(t_celsius, sat_vp_kpa):
    """[kPa degC-1] slope of the saturation curve (physics.cpp:130-133)."""
    return 4098.0 * sat_vp_kpa / sq(237.3 + t_celsius)


def pressure_from_altitude(height_m):
    """[Pa] barometric pressure (Allen et al. 1994; physics.cpp:39-47)."""
    return P0 * power(1.0 + div(height_m * LAPSE_RATE_MOIST_AIR, TP0),
                      -GRAVITY / (LAPSE_RATE_MOIST_AIR * R_DRY_AIR))


def latent_heat_vaporization(t_celsius):
    """[J kg-1] (physics.cpp:149-152)."""
    return 2501000.0 - 2369.2 * t_celsius


def dew_point_from_rh(t_celsius, rel_humidity):
    """Dew point [degC] from T and RH% -- Tetens inversion consistent with
    :func:`saturation_vapor_pressure` (tDewFromRelHum, meteo.cpp:210-222)."""
    rh = torch.clamp(rel_humidity, 1.0, 100.0)
    ea = div(rh, 100.0) * saturation_vapor_pressure(t_celsius)
    ln = torch.log(div(torch.clamp_min(ea, 1e-6), 611.0))
    return 240.97 * ln / (17.502 - ln)


def rh_from_dew_point(t_celsius, t_dew_celsius):
    """RH% from T and dew point (relHumFromTdew, meteo.cpp:191-207)."""
    td = torch.minimum(t_dew_celsius, t_celsius)
    rh = 100.0 * (saturation_vapor_pressure(td)
                  / saturation_vapor_pressure(t_celsius))
    return torch.clamp(rh, 0.0, 100.0)


def psychrometric_constant(pressure_kpa, t_celsius):
    """[kPa degC-1] (physics.cpp:161-164)."""
    return CP * pressure_kpa / (RATIO_WATER_VD
                                * latent_heat_vaporization(t_celsius))


def air_density(t_kelvin, pressure_pa=P0):
    """[kg m-3] dry-air ideal gas."""
    if isinstance(pressure_pa, torch.Tensor):
        return pressure_pa / (R_DRY_AIR * t_kelvin)
    return rdiv(pressure_pa, R_DRY_AIR * t_kelvin)


def vapor_concentration_from_pressure(vp_pa, t_kelvin):
    """[kg m-3] vapor concentration from partial pressure (physics.cpp)."""
    return vp_pa * 0.018 / (R_GAS * t_kelvin)


def emissivity_from_vapor_pressure(vp_kpa):
    """NET emissivity for outgoing longwave (meteo.cpp:433-436): the FAO
    net-emissivity term (0.34 - 0.14*sqrt(ea)) of the net-radiation
    budget, not an atmospheric emissivity (see
    :func:`atmospheric_emissivity_brutsaert`)."""
    return 0.34 - 0.14 * torch.sqrt(vp_kpa)


def atmospheric_emissivity_brutsaert(vp_pa, t_kelvin):
    """Clear-sky atmospheric emissivity for incoming longwave, Brutsaert
    (1975): eps = 1.24 * (ea[hPa] / T[K])^(1/7)."""
    ea_hpa = div(torch.clamp_min(vp_pa, 1.0), 100.0)
    return torch.clamp(1.24 * power(ea_hpa / t_kelvin, 1.0 / 7.0), 0.0, 1.0)


def et0_penman_hourly(height, normalized_transmissivity, global_irradiance,
                      air_temp, air_hum, wind_speed_10):
    """Hourly reference ET [mm h-1] (CIMIS Penman-Monteith,
    ET0_Penman_hourly, meteo.cpp:550-610).

    height [m asl]; normalized_transmissivity [0-1]; global_irradiance
    [W m-2]; air_temp [degC]; air_hum [%]; wind_speed_10 [m s-1 at 10 m]."""
    es = div(saturation_vapor_pressure(air_temp), 1000.0)   # [kPa]
    ea = div(air_hum * es, 100.0)
    emissivity = emissivity_from_vapor_pressure(ea)
    t_air_k = air_temp + ZEROCELSIUS
    sigma_h = STEFAN_BOLTZMANN * HOUR_SECONDS
    cloud_factor = torch.clamp_min(
        1.35 * torch.clamp_max(normalized_transmissivity, 1.0) - 0.35, 0.0)
    net_lw = cloud_factor * emissivity * sigma_h * ipow(t_air_k, 4)
    net_sw = HOUR_SECONDS * global_irradiance
    net_rad = (1.0 - ALBEDO_CROP_REFERENCE) * net_sw - net_lw

    positive = net_rad > 0
    g = torch.where(positive, 0.1 * net_rad, 0.5 * net_rad)
    cd = where(positive, 0.24, 0.96, net_rad.dtype)

    delta = saturation_slope(air_temp, es)
    pressure = div(pressure_from_altitude(height), 1000.0)
    gamma = psychrometric_constant(pressure, air_temp)
    lam = latent_heat_vaporization(air_temp)
    wind2 = wind_speed_10 * 0.748

    denom = delta + gamma * (1.0 + cd * wind2)
    first = delta * (net_rad - g) / (lam * denom)
    second = gamma * rdiv(37.0, t_air_k) * wind2 * (es - ea) / denom
    return torch.clamp_min(first + second, 0.0)


def daily_extraterrestrial_radiation(latitude_deg, doy):
    """[MJ m-2 d-1] FAO daily extraterrestrial radiation
    (dailyExtrRadiation, meteo.cpp:335-355)."""
    doy = as_f64(doy, latitude_deg.device)
    phi = math.pi / 180.0 * latitude_deg
    delta = 0.4093 * torch.sin(2.0 * math.pi / 365.0 * doy - 1.39)
    dr = 1.0 + 0.033 * torch.cos(div(2.0 * math.pi * doy, 365.0))
    omega_s = torch.arccos(torch.clamp(-torch.tan(phi) * torch.tan(delta),
                                       -1.0, 1.0))
    return (div(SOLAR_CONSTANT * DAY_SECONDS / 1e6 * dr, math.pi)
            * (omega_s * torch.sin(phi) * torch.sin(delta)
               + torch.cos(phi) * torch.cos(delta) * torch.sin(omega_s)))


def et0_hargreaves_daily(kt, latitude_deg, doy, t_max, t_min):
    """Daily Hargreaves-Samani ET0 [mm d-1] (ET0_Hargreaves,
    meteo.cpp:682-697); kt: Samani coefficient (default 0.17)."""
    ra = daily_extraterrestrial_radiation(latitude_deg, doy)
    delta_t = torch.clamp_min(torch.abs(t_max - t_min), 0.25)
    t_avg = 0.5 * (t_max + t_min)
    # 2.456 MJ kg-1 latent heat of vaporization
    return torch.clamp_min(
        0.0135 * (t_avg + 17.78) * kt * div(ra, 2.456) * torch.sqrt(delta_t),
        0.0)


def thom_index(t_celsius, rel_humidity, n_iter: int = 30):
    """Thom discomfort index (computeThomIndex, meteo.cpp:701-723): the
    wet-bulb temperature by ``n_iter`` fixed-point iterations (JAX's
    ``fori_loop`` as a host loop)."""
    t = as_f64(t_celsius)
    rh = as_f64(rel_humidity, t.device)
    es = 0.611 * torch.exp(17.27 * t / (t + 273.15 - 36.0))
    twb = t
    for _ in range(n_iter):
        t1 = div(t + twb, 2.0)
        es1 = 0.611 * torch.exp(17.27 * t1 / (t1 + 273.15 - 36.0))
        delta = es1 / (t1 + 273.15) * torch.log(rdiv(207700000.0, es1))
        twb = t - es * (1.0 - div(rh, 100.0)) / (delta + 0.06667)
    return 0.4 * (t + twb) + 4.8


def daily_bic(prec_mm, et0_mm):
    """Daily climatic water balance rain - ET0 [mm]
    (computeDailyBIC, meteo.cpp:358-372)."""
    return as_f64(prec_mm) - as_f64(et0_mm)


def daily_thermal_range(t_min, t_max):
    """(dailyThermalRange, meteo.cpp)."""
    return as_f64(t_max) - as_f64(t_min)


def heating_degree_days(t_avg, base: float = 20.0):
    """Daily heating degree days max(0, base - Tavg) (base 20 degC)."""
    return torch.clamp_min(base - as_f64(t_avg), 0.0)


def cooling_degree_days(t_avg, base: float = 24.0):
    """Daily cooling degree days max(0, Tavg - base)."""
    return torch.clamp_min(as_f64(t_avg) - base, 0.0)


def wind_cartesian(intensity, direction_deg):
    """(u, v) components from speed + meteorological direction
    (computeWindCartesian, meteo.cpp:726-739)."""
    angle = 90.0 - as_f64(direction_deg)
    angle = torch.where(angle < 0.0, angle + 360.0, angle)
    rad = angle * (math.pi / 180)
    i = as_f64(intensity, angle.device)
    return -i * torch.cos(rad), -i * torch.sin(rad)


def wind_polar(u, v):
    """(intensity, direction) from cartesian components
    (computeWindPolar, meteo.cpp:742-760)."""
    u = as_f64(u)
    v = as_f64(v, u.device)
    intensity = torch.sqrt(u * u + v * v)
    angle = torch.atan2(-v, -u) * (180 / math.pi)
    direction = 90.0 - angle
    direction = torch.where(direction < 0.0, direction + 360.0, direction)
    direction = torch.where(direction >= 360.0, direction - 360.0, direction)
    return intensity, direction


def et0_penman_daily(doy, elevation_m, latitude_deg, t_min, t_max,
                     wind_10m, rh_mean_pct, sw_global_mj):
    """Daily Penman-Monteith ET0 [mm d-1] (ET0_Penman_daily,
    meteo.cpp:560-630), with the reference's operator-precedence quirk
    ``pow(Tmax,4) + pow(Tmin,4) / 2`` kept. ``sw_global_mj`` in
    MJ m-2 d-1."""
    t_min, t_max = as_f64(t_min), as_f64(t_max)
    t_med = 0.5 * (t_min + t_max)
    extra = daily_extraterrestrial_radiation(latitude_deg, doy)
    trans = where(extra > 0.0,
                  torch.clamp_max(sw_global_mj / torch.clamp_min(extra, 1e-9),
                                  0.75),
                  0.0)
    pressure = 101.3 * power(div(293.0 - 0.0065 * elevation_m, 293.0), 5.26)
    psychro = psychrometric_constant(pressure, t_med)
    es = 0.61078 * torch.exp(17.27 * t_med / (t_med + 237.3))
    ea = div(es * rh_mean_pct, 100.0)
    delta = saturation_slope(t_med, es)
    sb_daily = 5.670373e-8 * 86400.0 / 1e6           # [MJ m-2 d-1 K-4]
    emissivity = emissivity_from_vapor_pressure(ea)
    lw_net = sb_daily * (ipow(t_max + 273.0, 4) + div(ipow(t_min + 273.0, 4), 2.0)) \
        * emissivity * (1.35 * div(trans, 0.75) - 0.35)
    sw_net = sw_global_mj * (1.0 - 0.23)             # ALBEDO_CROP_REFERENCE
    net_rad = sw_net - lw_net
    lam = div(latent_heat_vaporization(t_med), 1e6)  # [MJ kg-1]
    v2 = wind_10m * 0.748
    evap_demand = rdiv(900.0, t_med + 273.0) * v2 * (es - ea)
    return (delta * net_rad + psychro * evap_demand / lam) \
        / (delta + psychro * (1.0 + 0.34 * v2))


def et0_penman_hourly_net_rad(height_m, net_irradiance, t_air, rh_pct,
                              wind_10m):
    """Hourly Penman-Monteith ET0 [mm h-1] from a MEASURED net irradiance
    [W m-2] (ET0_Penman_hourly_net_rad, meteo.cpp:632-690)."""
    net_rad = 3600.0 * as_f64(net_irradiance)
    es = div(saturation_vapor_pressure(t_air), 1000.0)   # [kPa]
    ea = div(rh_pct * es, 100.0)
    t_k = as_f64(t_air) + 273.15
    g = torch.where(net_rad > 0.0, 0.1 * net_rad, 0.5 * net_rad)
    cd = where(net_rad > 0.0, 0.24, 0.96, net_rad.dtype)
    delta = saturation_slope(t_air, es)
    pressure = div(pressure_from_altitude(height_m), 1000.0)
    gamma = psychrometric_constant(pressure, t_air)
    lam = latent_heat_vaporization(t_air)
    v2 = wind_10m * 0.748
    den = delta + gamma * (1.0 + cd * v2)
    first = delta * (net_rad - g) / (lam * den)
    second = gamma * rdiv(37.0, t_k) * v2 * (es - ea) / den
    return torch.clamp_min(first + second, 0.0)

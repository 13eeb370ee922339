"""Brooks single-layer snowpack energy-budget model, element-wise on maps.

PyTorch counterpart of ``criteria3d_tpu/physics/snow.py``
(Crit3DSnow::computeSnowBrooksModel, src/snow/snow.cpp:142-580) as one
element-wise pass over (R, C) maps, with the JAX package's quirks kept:
``SnowParameters.compat_enum_snow_ratio`` (DEVIATIONS #25) and the
free-water skip that applies only while a cell is ponded.

Units follow the reference: SWE/ice/liquid in [mm], energies in [kJ m-2],
temperatures in [degC], precipitation in [mm/h], radiation in [W m-2].
"""

from __future__ import annotations

import dataclasses

import torch

from criteria3d_tpu_torch.constants import (EPSILON, NODATA, VON_KARMAN,
                                            ZEROCELSIUS)
from criteria3d_tpu_torch.core.soil import power
from criteria3d_tpu_torch.device import map_tensors, resolve_device
from criteria3d_tpu_torch.ops import div, ipow, where

__all__ = ["SnowParameters", "SnowState", "SnowForcing", "snow_step",
           "aerodynamic_resistance_campbell77", "dew_point_from_rh",
           "SNOW_RANGE"]

# torch.profiler range of the snow step (chip_smoke.py reads it)
SNOW_RANGE = "c3d.snow"

# snow.h:7-25
SNOW_EMISSIVITY = 0.97
SOIL_EMISSIVITY = 0.92
THERMO_WATER_VAPOR = 0.4615         # [kJ kg-1 K-1]
LATENT_HEAT_FUSION_KJ = 335.0       # [kJ kg-1]
LATENT_HEAT_VAPORIZATION_KJ = 2500.0
SNOW_SPECIFIC_HEAT = 2.1            # [kJ kg-1 degC-1]
SOIL_SPECIFIC_HEAT = 1.4
DEFAULT_BULK_DENSITY = 1350.0       # [kg m-3]
SOIL_DAMPING_DEPTH = 0.3            # [m]
SNOW_MINIMUM_HEIGHT = 1.0           # [mm]
WATER_DENSITY = 1000.0
HEAT_CAPACITY_AIR = 1290.0          # [J m-3 K-1] commonConstants.h:220
HEAT_CAPACITY_WATER = 4182000.0     # [J m-3 K-1] commonConstants.h:219
HEAT_CAPACITY_SNOW = 2100000.0      # [J m-3 K-1] commonConstants.h:221
STEFAN_BOLTZMANN = 5.670373e-8


@dataclasses.dataclass(frozen=True)
class SnowParameters:
    """Crit3DSnowParameters defaults (snow.cpp:39-50)."""

    skin_thickness: float = 0.02            # [m]
    soil_albedo: float = 0.2
    snow_vegetation_height: float = 1.0     # [m]
    water_holding_capacity: float = 0.05
    temp_max_with_snow: float = 2.0         # [degC]
    temp_min_with_rain: float = -0.5        # [degC]
    snow_surface_damping_depth: float = 0.05  # [m]
    # reproduce snow.cpp:482, where the unqualified `snowWaterEquivalent`
    # resolves to the meteoVariable ENUM (= 56) instead of the SWE member,
    # making the surface-energy snow ratio the constant
    # min(0.056, skin)/damping = 0.4 (upstream defect, DEVIATIONS #25).
    # False restores the intended SWE-dependent thin-pack scaling.
    compat_enum_snow_ratio: bool = True


@dataclasses.dataclass(frozen=True, eq=False)
class SnowState:
    """Per-cell snowpack prognostic state, all (R, C)."""

    swe: torch.Tensor               # [mm] snow water equivalent
    ice: torch.Tensor               # [mm]
    liquid: torch.Tensor            # [mm]
    internal_energy: torch.Tensor   # [kJ m-2]
    surface_energy: torch.Tensor    # [kJ m-2]
    surface_temp: torch.Tensor      # [degC]
    age: torch.Tensor               # [days]; NODATA when no snow

    @staticmethod
    def zero(shape, surface_temp=5.0, dtype=torch.float64,
             device=None) -> "SnowState":
        """No snow, soil at ``surface_temp``; ``device=None`` means the CUDA
        card."""
        dev = resolve_device(device)

        def z(v):
            return torch.full(tuple(shape), v, dtype=dtype, device=dev)

        t0 = z(surface_temp)
        ie = t0 * DEFAULT_BULK_DENSITY * SOIL_SPECIFIC_HEAT * SOIL_DAMPING_DEPTH
        se = t0 * DEFAULT_BULK_DENSITY * SOIL_SPECIFIC_HEAT * 0.02
        return SnowState(swe=z(0.0), ice=z(0.0), liquid=z(0.0),
                         internal_energy=ie, surface_energy=se,
                         surface_temp=t0, age=z(NODATA))

    def to(self, device) -> "SnowState":
        return map_tensors(self, lambda t: t.to(device))


@dataclasses.dataclass(frozen=True, eq=False)
class SnowForcing:
    """Hourly meteorological forcing maps, all (R, C)."""

    air_temp: torch.Tensor          # [degC]
    precipitation: torch.Tensor     # [mm/h]
    rel_humidity: torch.Tensor      # [%]
    wind_speed: torch.Tensor        # [m s-1] at 10 m
    global_radiation: torch.Tensor  # [W m-2]
    beam_radiation: torch.Tensor    # [W m-2]
    transmissivity: torch.Tensor    # [-]
    clear_sky_transmissivity: torch.Tensor  # [-]
    surface_water: torch.Tensor     # [mm] free water on the surface


def dew_point_from_rh(rh, t):
    """[degC] dew point (tDewFromRelHum, meteo.cpp:275-285)."""
    rh = torch.clamp(rh, 1e-6, 100.0)
    sat_vp = torch.exp((16.78 * t - 116.9) / (t + 237.3))
    vp = div(rh, 100.0) * sat_vp
    log_vp = torch.log(vp)
    return (log_vp * 237.3 + 116.9) / (16.78 - log_vp)


def aerodynamic_resistance_campbell77(is_snow, z_ref_wind: float, wind_speed,
                                      vegetation_height: float):
    """[s m-1] resistance to heat transfer (snow.cpp:523-560, Brooks 3.18);
    ``z_ref_wind`` and ``vegetation_height`` are Python numbers."""
    dt = wind_speed.dtype
    wind = torch.clamp(wind_speed, 0.05, 10.0)
    veg = max(vegetation_height, 0.01)
    zero_plane = where(is_snow, 0.0, 0.64 * veg, dt)
    z_m = where(is_snow, 0.001, 0.13 * veg, dt)
    log1 = torch.log((torch.clamp_min(z_ref_wind - zero_plane, 1.0) + z_m) / z_m)
    z_h = 0.2 * z_m
    log2 = torch.log((torch.clamp_min(2.0 - zero_plane, 1.0) + z_h) / z_h)
    return log1 * log2 / (VON_KARMAN ** 2 * wind)


def _vapor_density(t_celsius):
    """Saturated vapor density [kg m-3] (Tetens/Jensen form, snow.cpp:3.20)."""
    return (torch.exp((16.78 * t_celsius - 116.9) / (t_celsius + 237.3))
            / ((ZEROCELSIUS + t_celsius) * THERMO_WATER_VAPOR))


def snow_step(state: SnowState, forcing: SnowForcing,
              params: SnowParameters = SnowParameters()):
    """One hourly snowpack step.

    Returns ``(new_state, outputs)`` where outputs is a dict with
    ``snow_fall``, ``rain``, ``snow_melt`` [mm] (the water source handed to
    the 3-D water model), ``evaporation`` [mm] and the sensible and latent
    heat fluxes."""
    with torch.profiler.record_function(SNOW_RANGE):
        return _snow_step(state, forcing, params)


def _snow_step(state: SnowState, forcing: SnowForcing, p: SnowParameters):
    surface_water = torch.clamp_min(forcing.surface_water, 0.0)
    air_t = forcing.air_temp
    prec = forcing.precipitation

    # --- rain / snow partition (computeSnowFall, snow.cpp:121-140) ---
    frac = div(air_t - p.temp_min_with_rain,
               p.temp_max_with_snow - p.temp_min_with_rain)
    liquid_water = torch.where(prec > 0, prec * torch.clamp(frac, 0.0, 1.0), prec)
    prec_snow = torch.clamp_min(prec - liquid_water, 0.0)
    prec_rain = liquid_water

    dew_point = dew_point_from_rh(forcing.rel_humidity, air_t)
    cloud_cover = where(
        forcing.transmissivity != NODATA,
        1.0 - torch.clamp_max(
            forcing.transmissivity
            / torch.clamp_min(forcing.clear_sky_transmissivity, 1e-6), 1.0),
        0.1)

    # vegetation shadowing of beam radiation (snow.cpp:202-209)
    max_snow_height = div(state.swe * 10.0, 1000.0)          # [m]
    height_veg = p.snow_vegetation_height - max_snow_height
    veg_shadow = torch.clamp(div(height_veg, 4.0), 0.0, 1.0)
    solar_rad_tot = forcing.global_radiation - forcing.beam_radiation * veg_shadow

    prev_swe = state.swe
    has_snow = prev_swe > 0

    # re-derive ice/liquid after manual SWE edits (snow.cpp:221-246)
    needs_reset = has_snow & (state.ice <= 0) & (state.liquid <= 0)
    ice0 = torch.where(needs_reset, prev_swe, state.ice)
    liq0 = torch.where(
        needs_reset,
        div(prev_swe * p.water_holding_capacity, 1 - p.water_holding_capacity),
        state.liquid)
    ie0 = torch.where(needs_reset,
                      -prev_swe * 0.001 * LATENT_HEAT_FUSION_KJ * WATER_DENSITY,
                      state.internal_energy)
    st0 = torch.where(needs_reset, torch.clamp_max(state.surface_temp, 0.0),
                      state.surface_temp)
    se0 = torch.where(
        needs_reset,
        st0 * WATER_DENSITY * SNOW_SPECIFIC_HEAT
        * torch.clamp_max(prev_swe, p.skin_thickness),
        state.surface_energy)
    age0 = where(needs_reset, 1.0, state.age)

    ratio = prev_swe / torch.clamp_min(ice0 + liq0, 1e-12)
    ice0 = where(has_snow, ice0 * ratio, 0.0)
    liq0 = where(has_snow, liq0 * ratio, 0.0)
    age0 = where(has_snow, age0, NODATA)

    # soil internal-energy sanity check (snow.cpp:252-274)
    est_ie = st0 * DEFAULT_BULK_DENSITY * SOIL_SPECIFIC_HEAT * SOIL_DAMPING_DEPTH
    est_ie = where(est_ie == 0, EPSILON, est_ie)
    ratio_ie = ie0 / est_ie
    fix_ie = (prev_swe < EPSILON) & (torch.abs(est_ie - ie0) > 1000.0) \
        & ((ratio_ie < 0.5) | (ratio_ie > 2.0))
    ie0 = torch.where(fix_ie, 0.5 * (ie0 + est_ie), ie0)

    # aerodynamic resistance + vapor densities (snow.cpp:278-297)
    res = aerodynamic_resistance_campbell77(
        prev_swe > SNOW_MINIMUM_HEIGHT, 10.0, forcing.wind_speed,
        p.snow_vegetation_height)
    air_vap_density = _vapor_density(dew_point)
    surf_vap_density = _vapor_density(st0)

    # longwave emissivity (Unsworth & Monteith 1975; snow.cpp:305)
    lw_emissivity = (0.72 + 0.005 * air_t) * (1.0 - 0.84 * cloud_cover) \
        + 0.84 * cloud_cover

    # age-dependent snow albedo (O'Neill & Gray 1973; snow.cpp:308-314)
    albedo = where(
        age0 != NODATA,
        torch.clamp_max(0.74 * power(torch.clamp_min(age0, 1e-6), -0.191), 0.9),
        p.soil_albedo)

    # --- incoming energy fluxes [kJ m-2 h-1] (snow.cpp:317-380) ---
    q_precip = (HEAT_CAPACITY_WATER / 1000.0) * div(prec_rain, 1000.0) \
        * (torch.clamp_min(air_t, 0.0) - st0) \
        + (HEAT_CAPACITY_SNOW / 1000.0) * div(prec_snow, 1000.0) \
        * (torch.clamp_max(air_t, 0.0) - st0)
    q_water_heat = (HEAT_CAPACITY_WATER / 1000.0) * div(surface_water, 1000.0) \
        * (torch.clamp_min(0.5 * (st0 + air_t), 1.0) - st0)
    q_solar = div((1.0 - albedo) * solar_rad_tot * 3600.0, 1000.0)
    surf_emissivity = where(prev_swe > SNOW_MINIMUM_HEIGHT,
                            SNOW_EMISSIVITY, SOIL_EMISSIVITY, prev_swe.dtype)
    q_longwave = STEFAN_BOLTZMANN * 3.6 * (
        lw_emissivity * ipow(air_t + ZEROCELSIUS, 4)
        - surf_emissivity * ipow(st0 + ZEROCELSIUS, 4))
    q_sensible = 3600.0 * (HEAT_CAPACITY_AIR / 1000.0) * (air_t - st0) / res
    q_latent = 3600.0 * (LATENT_HEAT_VAPORIZATION_KJ + LATENT_HEAT_FUSION_KJ) \
        * (air_vap_density - surf_vap_density) / res
    q_latent = torch.where(prev_swe < EPSILON, q_latent * 0.4, q_latent)

    q_total = (q_solar + q_precip + q_longwave + q_sensible + q_latent
               + q_water_heat)

    # --- sublimation / evaporation [mm] (snow.cpp:385-404) ---
    subl_raw = div(q_latent, LATENT_HEAT_FUSION_KJ + LATENT_HEAT_VAPORIZATION_KJ)
    sublimation = where(
        prev_swe > EPSILON,
        torch.where(subl_raw < 0,
                    -torch.minimum(torch.abs(subl_raw), prev_swe + prec_snow),
                    subl_raw),
        0.0)
    evaporation = where(sublimation < 0, -sublimation, 0.0)

    # --- refreeze / melt (snow.cpp:407-428, Brooks 3.25) ---
    w = div(ie0 + q_total, LATENT_HEAT_FUSION_KJ * WATER_DENSITY)   # [m]
    freeze = where((w < 0) & (st0 <= 0),
                   torch.minimum(liq0 + prec_rain, -w * 1000.0), 0.0)
    melt = where(w > 0,
                 -torch.minimum(ice0 + prec_snow + sublimation, w * 1000.0),
                 0.0)
    freeze_melt = freeze + melt          # [mm]; >0 freeze, <0 melt
    snow_melt = -freeze_melt

    q_r = div(freeze_melt, 1000.0) * LATENT_HEAT_FUSION_KJ * WATER_DENSITY
    internal_energy = ie0 + q_total + q_r

    # --- snowpack mass (snow.cpp:441-470) ---
    frozen_pack = internal_energy <= EPSILON
    ice = where(frozen_pack,
                torch.clamp_min(ice0 + prec_snow + sublimation + freeze_melt, 0.0),
                0.0)
    whc = p.water_holding_capacity / (1 - p.water_holding_capacity)
    liquid = where(
        frozen_pack,
        torch.minimum(torch.clamp_min(liq0 + prec_rain + surface_water
                                      - freeze_melt, 0.0), ice * whc),
        0.0)
    swe = ice + liquid

    # --- surface energy & temperature (snow.cpp:472-497) ---
    if p.compat_enum_snow_ratio:
        # snow.cpp:482 upstream defect: `snowWaterEquivalent` is the
        # meteoVariable enum (56), not the member -- constant ratio
        snow_ratio = min(56.0 * 0.001, p.skin_thickness) \
            / p.snow_surface_damping_depth
    else:
        snow_ratio = div(torch.clamp_max(swe * 0.001, p.skin_thickness),
                         p.snow_surface_damping_depth)
    se_snow = where((swe > 0) & (torch.abs(internal_energy) < EPSILON),
                    0.0,
                    torch.clamp_max(se0 + (q_total + q_r) * snow_ratio, 0.0))
    t_snow = div(se_snow, WATER_DENSITY * SNOW_SPECIFIC_HEAT * p.skin_thickness)

    se_soil = se0 + (q_total + q_r) * (p.skin_thickness / SOIL_DAMPING_DEPTH)
    t_soil = div(se_soil, DEFAULT_BULK_DENSITY * SOIL_SPECIFIC_HEAT
                 * p.skin_thickness)

    snow_fraction = div(torch.clamp_max(div(swe * 4.0, 1000.0), p.skin_thickness),
                        p.skin_thickness)
    surface_energy = se_snow * snow_fraction + se_soil * (1 - snow_fraction)
    surface_temp = t_snow * snow_fraction + t_soil * (1 - snow_fraction)

    # --- snow age [days] (snow.cpp:499-516) ---
    age = where(
        swe > EPSILON,
        where((age0 == NODATA) | (prec_snow > 0.1), 0.0, age0 + 1.0 / 24.0),
        NODATA)

    # --- free-water skip (snow.cpp:168-190): cells carrying >100 mm of
    # free surface water do not hold a snowpack -- the pack is invalidated
    # and the whole precipitation passes through as rain, only while the
    # cell is ponded (the JAX package's deviation from the reference's
    # sticky NODATA state, DEVIATIONS.md).
    is_water = surface_water > 100.0
    zero = torch.zeros_like(swe)
    new_state = SnowState(
        swe=torch.where(is_water, zero, swe),
        ice=torch.where(is_water, zero, ice),
        liquid=torch.where(is_water, zero, liquid),
        internal_energy=torch.where(is_water, zero, internal_energy),
        surface_energy=torch.where(is_water, zero, surface_energy),
        surface_temp=torch.where(is_water, forcing.air_temp, surface_temp),
        age=where(is_water, NODATA, age))
    outputs = dict(
        snow_fall=torch.where(is_water, zero, prec_snow),
        rain=torch.where(is_water, prec, prec_rain),
        snow_melt=torch.where(is_water, zero, snow_melt),
        evaporation=torch.where(is_water, zero, evaporation),
        sensible_heat=torch.where(is_water, zero, q_sensible),
        latent_heat=torch.where(is_water, zero, q_latent))
    return new_state, outputs

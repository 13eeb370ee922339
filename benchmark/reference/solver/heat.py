"""Coupled soil heat transport: diffusion + latent (vapor) terms.

The port's eager heat code (the reference's agrolib/soilFluxes3D/heat.cpp)
on the path the cells run: Crank-Nicolson-weighted conduction on the water
solver's stencil, the de Vries/Campbell soil thermal conductivity,
Philip-de Vries vapor conductivities, the atmospheric surface energy
balance boundary, and the chunk-frozen heat system of ``heat_frozen_props``
with its float32 Jacobi sweeps and float64 balance, on one whole box, with
vapor (``heat_vapor``) and without advection.

The dtype rules of solver/water.py and ops.py hold here too: a 0-d float64
tensor times a float32 tensor is float64 in JAX but float32 in torch, so
such products cast first (:func:`_mul0`); and a tensor is divided by a
Python constant through a 0-d tensor of its own dtype (:func:`_div`,
:func:`_rdiv`), because CUDA turns division by a host scalar into
multiplication by its rounded reciprocal, and torch turns ``c / tensor``
into ``c * reciprocal(tensor)``. Integer powers are products; other powers
go through :func:`benchmark.reference.core.soil.power`.

The Jacobi sweep loop is a host loop that reads the max-norm once per
sweep through ``device.host_read``; the sub-step's balance decision reads
its MBR once. Time-step lengths are Python floats (float64 on the host).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference import precision
from benchmark.reference.constants import (GRAVITY, MH2O, R_GAS,
                                            VON_KARMAN, WATER_DENSITY,
                                            ZEROCELSIUS)
from benchmark.reference.core.grid import Grid
from benchmark.reference.core.soil import (MeanType, compute_mean, power,
                                            se_from_psi, theta_from_se)
from benchmark.reference.core.state import SolverParameters, WaterState
from benchmark.reference.device import host_read, map_tensors, resolve_device, scalar
from benchmark.reference.meteo import (
    P0, pressure_from_altitude, saturation_vapor_pressure,
    vapor_concentration_from_pressure)
from benchmark.reference.meteo import (
    latent_heat_vaporization as latent_vaporization_heat)
from benchmark.reference.ops import div as _div
from benchmark.reference.ops import mul0 as _mul0
from benchmark.reference.ops import rdiv as _rdiv
from benchmark.reference.ops import sq as _sq
from benchmark.reference.solver import water as W
from benchmark.reference.solver.shifts import LATERAL_OFFSETS, shift2d

__all__ = ["HeatState", "HeatBoundary", "heat_capacity",
           "soil_thermal_conductivity", "initialize_heat", "heat_storage",
           "update_boundary_heat", "heat_surface_water_sink",
           "thermal_water_flux", "surface_conductances",
           "chunk_frozen_system", "heat_substep_frozen", "energy_invariants",
           "heat_jacobi_solve"]

# commonConstants.h values used by the heat process
MINERAL_HK = 2.5                 # [W m-1 K-1] thermal conductivity of minerals
QUARTZ_DENSITY = 2.648           # [Mg m-3]
HEAT_CAPACITY_MINERAL = 231000.0  # [J Mg-1 ... ] as used: (bulk/quartz)*HCmineral
HEAT_CAPACITY_WATER = 4182000.0  # [J m-3 K-1]
HEAT_CAPACITY_AIR = 1290.0       # [J m-3 K-1]
HEAT_CAPACITY_WATER_VAPOR = 1996.0  # [J kg-1 K-1]
HEAT_CAPACITY_AIR_MOLAR = 29.31  # [J mol-1 K-1]
VAPOR_DIFFUSIVITY0 = 2.12e-5     # [m2 s-1]
GAMMA0 = 71.89                   # [g s-2] surface tension at 25 degC
THETAMIN = 0.15


def _heat_mask(grid: Grid) -> torch.Tensor:
    """Subsurface nodes (isHeatNode, heat.cpp:26-29)."""
    return W._set0(grid.mask, False)


def _masked_sum(mask, field):
    """The sum of ``field`` over the cells of ``mask``."""
    return torch.where(mask, field, 0.0).sum()


# ----------------------------------------------------------------------
# state and forcing
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class HeatState:
    """Subsurface temperature state, (L, R, C); layer 0 unused. The balance
    scalars are 0-d tensors (``None`` in the chunk system's stand-in
    state, which reads only the temperatures)."""

    t: torch.Tensor            # [K]
    t_old: torch.Tensor        # [K]
    sink_source: torch.Tensor | None  # [W]
    # balance scalars
    storage_prev: torch.Tensor | None
    storage_whole: torch.Tensor | None
    sink_whole: torch.Tensor | None
    mbr: torch.Tensor | None


@dataclasses.dataclass(frozen=True, eq=False)
class HeatBoundary:
    """Atmospheric forcing on HeatSurface nodes (boundaryData_t heat part,
    types.h:230-248). All (R, C) maps (applied to the first soil layer)."""

    mask: torch.Tensor            # bool: node has an atmospheric heat boundary
    air_temperature: torch.Tensor  # [K]
    rel_humidity: torch.Tensor     # [%]
    wind_speed: torch.Tensor       # [m s-1]
    net_irradiance: torch.Tensor   # [W m-2]
    height_wind: torch.Tensor      # [m]
    height_temperature: torch.Tensor  # [m]
    roughness_height: torch.Tensor    # [m]

    @staticmethod
    def uniform(shape, *, air_temperature=288.15, rel_humidity=60.0,
                wind_speed=2.0, net_irradiance=0.0, height_wind=10.0,
                height_temperature=2.0, roughness_height=0.01,
                mask=None, dtype=torch.float64, device=None) -> "HeatBoundary":
        """Spatially uniform forcing; ``device=None`` means the CUDA card."""
        dev = resolve_device(device)
        shape = tuple(shape)

        def f(v):
            return torch.full(shape, v, dtype=dtype, device=dev)

        if mask is None:
            mask = torch.ones(shape, dtype=torch.bool, device=dev)
        return HeatBoundary(mask=torch.as_tensor(mask, device=dev),
                            air_temperature=f(air_temperature),
                            rel_humidity=f(rel_humidity),
                            wind_speed=f(wind_speed),
                            net_irradiance=f(net_irradiance),
                            height_wind=f(height_wind),
                            height_temperature=f(height_temperature),
                            roughness_height=f(roughness_height))


def initialize_heat(grid: Grid, temperature_k, dtype=torch.float64) -> HeatState:
    """Uniform (or given) temperatures on the grid's nodes, 0 degC
    elsewhere; zero balance scalars."""
    dev = grid.device
    t = torch.broadcast_to(torch.as_tensor(temperature_k, dtype=dtype,
                                           device=dev), grid.shape)
    t = torch.where(grid.mask, t, ZEROCELSIUS)
    zero = torch.zeros((), dtype=dtype, device=dev)
    return HeatState(t=t, t_old=t, sink_source=torch.zeros(
        grid.shape, dtype=dtype, device=dev),
        storage_prev=zero, storage_whole=zero, sink_whole=zero, mbr=zero)


# ----------------------------------------------------------------------
# material properties (heat.cpp:700-1250)
# ----------------------------------------------------------------------

def soil_relative_humidity(h, t_k):
    """Kelvin equation (heat.cpp:1143-1146); h = matric potential [m]."""
    return torch.exp(MH2O * h * GRAVITY / (R_GAS * t_k))


def vapor_from_psi_temp(h, t_k):
    svp = saturation_vapor_pressure(t_k - ZEROCELSIUS)
    return vapor_concentration_from_pressure(svp, t_k) * soil_relative_humidity(h, t_k)


def air_molar_density(pressure, t_k):
    return 44.65 * _div(pressure, P0) * _rdiv(ZEROCELSIUS, t_k)


def air_volumetric_specific_heat(pressure, t_k):
    return HEAT_CAPACITY_AIR_MOLAR * air_molar_density(pressure, t_k)


def vapor_binary_diffusivity(t_k):
    return VAPOR_DIFFUSIVITY0 * _sq(_div(t_k, ZEROCELSIUS))


def soil_vapor_diffusivity(theta_s, theta, t_k):
    """Penman 1940 (heat.cpp:1124-1135)."""
    return vapor_binary_diffusivity(t_k) * 0.66 * torch.clamp_min(theta_s - theta, 0.0)


def soil_surface_resistance(theta_top):
    """Van De Griend & Owe 1994 (heat.cpp:1152-1155) [s m-1]."""
    return 10.0 * torch.exp(0.3563 * (THETAMIN - theta_top) * 100.0)


def estimate_bulk_density(grid: Grid):
    """[Mg m-3] (heat.cpp:1040-1066, Driessen 1986); organic matter 0.02,
    the reference's default for missing data."""
    om = 0.02
    particle_density = 1.0 / ((1.0 - om) / QUARTZ_DENSITY + om / 1.43)
    return (1.0 - grid.soil.theta_s) * particle_density


def theta_from_signed_psi(grid: Grid, params: SolverParameters, h_signed):
    """computeNodeTheta_fromSignedPsi (soilPhysics.cpp:50-61)."""
    se = torch.where(h_signed >= 0, 1.0,
                     se_from_psi(grid.soil, torch.abs(h_signed), params.wrc_model))
    return theta_from_se(grid.soil, se)


def _theta_layer1(grid: Grid, params: SolverParameters, h_signed):
    """``theta_from_signed_psi(grid, params, h_signed)[1]`` evaluated on
    layer 1 only (the same element-wise values)."""
    soil1 = map_tensors(grid.soil, lambda t: t[1])
    psi1 = h_signed[1]
    se = torch.where(psi1 >= 0, 1.0,
                     se_from_psi(soil1, torch.abs(psi1), params.wrc_model))
    return theta_from_se(soil1, se)


def water_return_flow_factor(theta, t_k, clay):
    """Campbell 1994 (heat.cpp:1084-1100)."""
    wc0 = 0.078 + 0.33 * clay
    q = (2.52 + 7.25 * clay) * _sq(_div(t_k, 303.0))
    ratio = torch.clamp_min(theta / wc0, 1e-12)
    f = 1.0 / (1.0 + power(ratio, -q))
    return torch.where(theta < 0.01 * wc0, 0.0, f)


def thermal_vapor_conductivity(grid: Grid, params: SolverParameters, t_k, h,
                               theta=None):
    """[kg m-1 s-1 K-1] (heat.cpp:783-830, Cass et al. 1984 enhancement)."""
    t_c = t_k - ZEROCELSIUS
    pressure = pressure_from_altitude(grid.z)
    if theta is None:
        theta = theta_from_signed_psi(grid, params, h)
    v_diff = soil_vapor_diffusivity(grid.soil.theta_s, theta, t_k)
    svp = saturation_vapor_pressure(t_c)
    svp_slope = 4098.0 * _div(svp, 1000.0) / _sq(237.3 + t_c)  # [kPa/degC]
    svc_slope = svp_slope * MH2O * air_molar_density(pressure, t_k) / pressure
    v_conc = vapor_from_psi_temp(h, t_k)
    v_press = _div(v_conc * R_GAS * t_k, MH2O)
    rh = v_press / svp
    sat_degree = theta / grid.soil.theta_s
    clay = torch.clamp_min(_clay(grid), 1e-3)
    y = _sq(_sq((1.0 + _rdiv(2.6, torch.sqrt(clay))) * sat_degree))
    eta = 9.5 + 3.0 * sat_degree - 8.5 * torch.exp(-y)
    return eta * v_diff * svc_slope * rh


def isothermal_vapor_conductivity(grid: Grid, params: SolverParameters, t_k, h,
                                  theta=None):
    """[kg s m-3] (heat.cpp:832-855)."""
    if theta is None:
        theta = theta_from_signed_psi(grid, params, h)
    v_diff = soil_vapor_diffusivity(grid.soil.theta_s, theta, t_k)
    v_conc = vapor_from_psi_temp(h, t_k)
    return v_diff * v_conc * MH2O / (R_GAS * t_k)


def _clay(grid: Grid):
    """Clay value fed to the Campbell return-flow and vapor-enhancement
    formulas: the reference passes the clay content as PERCENT
    (project3D.cpp:925) into a formula that expects a fraction
    (heat.cpp:1097-1110); reproduced as the JAX package reproduces it
    (DEVIATIONS #14)."""
    return torch.full_like(grid.soil.theta_s, 25.0)


def soil_thermal_conductivity(grid: Grid, params: SolverParameters, t_k, h,
                              with_vapor: bool = False, theta=None):
    """de Vries weighted mixture [W m-1 K-1] (heat.cpp:700-756);
    ``theta`` optionally passes a precomputed retention at ``h``."""
    t_c = t_k - ZEROCELSIUS
    w_frac = theta_from_signed_psi(grid, params, h) if theta is None else theta
    s_frac = 1.0 - grid.soil.theta_s
    a_frac = torch.clamp_min(grid.soil.theta_s - w_frac, 0.0)

    f_ret = water_return_flow_factor(w_frac, t_k, _clay(grid))
    k_w = 0.554 + 0.0024 * t_c - 0.00000987 * _sq(t_c)
    k_a = 0.024 + 0.0000773 * t_c - 0.000000026 * _sq(t_c)
    if with_vapor:
        k_a = k_a + latent_vaporization_heat(t_c) * thermal_vapor_conductivity(
            grid, params, t_k, h, theta=w_frac)
    k_f = k_a + f_ret * (k_w - k_a)

    ga = 0.088
    gc = 1.0 - 2.0 * ga

    def weight(r):
        return _div(_rdiv(2.0, 1.0 + r * ga) + _rdiv(1.0, 1.0 + r * gc), 3.0)

    wa = weight(k_a / k_f - 1.0)
    ww = weight(k_w / k_f - 1.0)
    ws = weight(_rdiv(MINERAL_HK, k_f) - 1.0)
    return ((w_frac * ww * k_w + a_frac * wa * k_a + s_frac * ws * MINERAL_HK)
            / (ww * w_frac + wa * a_frac + ws * s_frac))


def heat_capacity(grid: Grid, params: SolverParameters, h, t_k,
                  with_vapor: bool = False, theta=None):
    """Volumetric heat capacity [J m-3 K-1] (heat.cpp:857-877)."""
    if theta is None:
        theta = theta_from_signed_psi(grid, params, h)
    bulk = estimate_bulk_density(grid)
    hc = _div(bulk, QUARTZ_DENSITY) * HEAT_CAPACITY_MINERAL + theta * HEAT_CAPACITY_WATER
    if with_vapor:
        v_theta = (_div(vapor_from_psi_temp(h, t_k), WATER_DENSITY)
                   * torch.clamp_min(grid.soil.theta_s - theta, 0.0))
        hc = hc + v_theta * HEAT_CAPACITY_AIR
    return hc


# ----------------------------------------------------------------------
# atmospheric surface boundary (heat.cpp:879-1035)
# ----------------------------------------------------------------------

def aerodynamic_conductance(boundary: HeatBoundary, surface_t_k):
    """Monin-Obukhov iterative conductance [m s-1]
    (computeNodeAerodynamicConductance, heat.cpp:879-950): the JAX
    package's fixed 20 iterations, a host loop with no host read."""
    zero_plane = 0.77 * boundary.roughness_height
    r_mom = 0.13 * boundary.roughness_height
    r_heat = 0.2 * r_mom
    wind = torch.clamp_min(boundary.wind_speed, 0.01)
    t_air = boundary.air_temperature
    ch = air_volumetric_specific_heat(
        pressure_from_altitude(boundary.height_wind), t_air)
    log_m = torch.log((boundary.height_wind - zero_plane + r_mom) / r_mom)
    log_h = torch.log((boundary.height_temperature - zero_plane + r_heat) / r_heat)

    psi_m = torch.zeros_like(wind)
    psi_h = torch.zeros_like(wind)
    for _ in range(20):
        u_star = VON_KARMAN * wind / (log_m + psi_m)
        k = VON_KARMAN * u_star / (log_h + psi_h)
        h_flux = k * ch * (surface_t_k - t_air)
        sp = (-VON_KARMAN * boundary.height_wind * GRAVITY * h_flux
              / (ch * t_air * (u_star * _sq(u_star))))
        psi_h_new = torch.where(
            sp > 0, 6.0 * torch.log(1.0 + torch.clamp_min(sp, 0.0)),
            -2.0 * torch.log(_div(1.0 + torch.sqrt(
                1.0 - 16.0 * torch.clamp_max(sp, 0.0)), 2.0)))
        psi_m = torch.where(sp > 0, psi_h_new, 0.6 * psi_h_new)
        psi_h = psi_h_new
    u_star = VON_KARMAN * wind / (log_m + psi_m)
    return VON_KARMAN * u_star / (log_h + psi_h)


def thermal_liquid_conductivity(t_c, h_signed, k):
    """Temperature-gradient liquid conductivity [m2 s-1 K-1]
    (computeThermalLiquidConductivity, heat.cpp:1242-1250)."""
    gwt = 4.0
    d_gamma_dt = -0.1425 - 0.000576 * t_c
    return torch.clamp_min(_div(k * h_signed * gwt * d_gamma_dt, GAMMA0), 0.0)


def _up_down_ok(heat_mask):
    """Links to the soil node above (layer 1 has none) and below."""
    up_ok = torch.roll(heat_mask, 1, dims=0)
    up_ok[0] = False
    up_ok[1] = False
    down_ok = torch.roll(heat_mask, -1, dims=0)
    down_ok[-1] = False
    return up_ok, down_ok


def _vert_dist(grid: Grid):
    return torch.where(grid.vert_dist > 0, grid.vert_dist, 1.0)


def _link_sum(grid: Grid, node_field, t_field, heat_mask, mean_type):
    """Sum over all soil-soil links of mean(field_i, field_j) *
    (T_j - T_i) / dist * area: the shared stencil of the thermal liquid /
    vapor / latent link fluxes."""
    total = torch.zeros_like(node_field)
    field0 = torch.clamp_min(node_field, 0.0) + 1e-30

    def pair(nbr_field, nbr_t, nbr_ok, dist, area):
        avg = compute_mean(field0, torch.clamp_min(nbr_field, 0.0) + 1e-30,
                           mean_type)
        return torch.where(heat_mask & nbr_ok,
                           avg * (nbr_t - t_field) / dist * area, 0.0)

    up_ok, down_ok = _up_down_ok(heat_mask)
    dist_v = _vert_dist(grid)
    total = total + pair(torch.roll(node_field, 1, dims=0),
                         torch.roll(t_field, 1, dims=0), up_ok, dist_v,
                         grid.area)
    total = total + pair(torch.roll(node_field, -1, dims=0),
                         torch.roll(t_field, -1, dims=0), down_ok,
                         torch.roll(dist_v, -1, dims=0), grid.area)
    for idx, (di, dj) in enumerate(LATERAL_OFFSETS):
        nbr_ok = shift2d(heat_mask, di, dj, fill=False)
        total = total + pair(shift2d(node_field, di, dj),
                             shift2d(t_field, di, dj), nbr_ok,
                             grid.lat_dist3d[idx], grid.lat_area)
    return total


def thermal_water_flux(grid: Grid, params: SolverParameters,
                       heat: HeatState, psi, k):
    """Thermal liquid (+ vapor with ``heat_vapor``) water flows [m3 s-1]
    from a SIGNED psi and k iterate, at the mean temperature; the water
    solver adds them to its RHS only (the invariantFluxes mechanism).
    ``psi``/``k`` may be the float32 psi-carry fields."""
    heat_mask = _heat_mask(grid)
    t_mean = compute_mean(heat.t, heat.t_old, MeanType.ARITHMETIC)

    tlk = thermal_liquid_conductivity(t_mean - ZEROCELSIUS, psi, k)
    flux = _link_sum(grid, tlk, t_mean, heat_mask, params.mean_type)
    if params.heat_vapor:
        tvk = thermal_vapor_conductivity(grid, params, t_mean, psi)
        flux = flux + _div(_link_sum(grid, tvk, t_mean, heat_mask,
                                     params.mean_type), WATER_DENSITY)
    return torch.where(heat_mask, flux, 0.0)


def isothermal_latent_link_flux(grid: Grid, params: SolverParameters,
                                heat: HeatState, water: WaterState,
                                node_h, t_field=None, h_old=None,
                                theta=None):
    """Latent heat carried by isothermal vapor flow between nodes [W]
    (computeIsothermalLatentHeatFlux, heat.cpp:575-601). ``t_field`` /
    ``h_old`` override the state fields (the fast path passes float32
    copies); ``theta`` a precomputed retention at the link-mean head."""
    t = heat.t if t_field is None else t_field
    w_h_old = water.h_old if h_old is None else h_old
    heat_mask = _heat_mask(grid)
    avg_h = compute_mean(node_h, w_h_old, MeanType.ARITHMETIC) - grid.z
    ivk = isothermal_vapor_conductivity(grid, params, t, avg_h, theta=theta)
    lam = latent_vaporization_heat(t - ZEROCELSIUS)
    psi_e = avg_h * GRAVITY        # [J kg-1]
    ivk0 = torch.clamp_min(ivk, 1e-30)

    total = torch.zeros_like(ivk)

    def pair(nbr_ivk, nbr_lam, nbr_psi, nbr_ok, dist, area):
        avg_k = compute_mean(ivk0, torch.clamp_min(nbr_ivk, 1e-30),
                             params.mean_type)
        avg_lam = compute_mean(lam, nbr_lam, MeanType.ARITHMETIC)
        return torch.where(heat_mask & nbr_ok,
                           avg_lam * avg_k * (nbr_psi - psi_e) / dist * area,
                           0.0)

    up_ok, down_ok = _up_down_ok(heat_mask)
    dist_v = _vert_dist(grid)
    total = total + pair(torch.roll(ivk, 1, dims=0), torch.roll(lam, 1, dims=0),
                         torch.roll(psi_e, 1, dims=0), up_ok, dist_v, grid.area)
    total = total + pair(torch.roll(ivk, -1, dims=0), torch.roll(lam, -1, dims=0),
                         torch.roll(psi_e, -1, dims=0), down_ok,
                         torch.roll(dist_v, -1, dims=0), grid.area)
    for idx, (di, dj) in enumerate(LATERAL_OFFSETS):
        nbr_ok = shift2d(heat_mask, di, dj, fill=False)
        total = total + pair(shift2d(ivk, di, dj), shift2d(lam, di, dj),
                             shift2d(psi_e, di, dj), nbr_ok,
                             grid.lat_dist3d[idx], grid.lat_area)
    return total


def boundary_vapor_concentration(boundary: HeatBoundary):
    """Atmospheric vapor [kg m-3] at the boundary temperature/RH, and the
    saturated concentration."""
    sat_p = saturation_vapor_pressure(boundary.air_temperature - ZEROCELSIUS)
    sat_c = vapor_concentration_from_pressure(sat_p, boundary.air_temperature)
    return _div(sat_c * boundary.rel_humidity, 100.0), sat_c


def surface_conductances(grid: Grid, params: SolverParameters,
                         heat: HeatState, boundary: HeatBoundary, h):
    """(aerodynamic, soil-surface) conductances [m s-1] of the HeatSurface
    nodes from the current state; the coupled step freezes them once per
    computeStep (updateConductance, heat.cpp:214-236)."""
    aero_k = aerodynamic_conductance(boundary, heat.t[1])
    theta_top = _theta_layer1(grid, params, h - grid.z)
    soil_k = 1.0 / soil_surface_resistance(theta_top)
    return aero_k, soil_k


def atmospheric_latent_vapor_flux(grid: Grid, params: SolverParameters,
                                  heat: HeatState, boundary: HeatBoundary,
                                  water, aero_k=None, soil_k=None):
    """Soil->atmosphere vapor flux [kg m-2 s-1] on HeatSurface nodes
    (computeNodeAtmosphericLatentVaporFlux, heat.cpp:988-1007). ``water``
    is a WaterState or a bare SIGNED-psi field."""
    psi = (water.h - grid.z) if isinstance(water, WaterState) else water
    if aero_k is None:
        aero_k = aerodynamic_conductance(boundary, heat.t[1])
    if soil_k is None:
        soil_k = 1.0 / soil_surface_resistance(_theta_layer1(grid, params, psi))
    boundary_vapor, _ = boundary_vapor_concentration(boundary)
    node_vapor = vapor_from_psi_temp(psi[1], heat.t[1])
    total_k = 1.0 / (1.0 / torch.clamp_min(aero_k, 1e-9)
                     + 1.0 / torch.clamp_min(soil_k, 1e-9))
    return (boundary_vapor - node_vapor) * total_k


def atmospheric_latent_surface_water_flux(boundary: HeatBoundary, aero_k):
    """Ponded-surface evaporation vapor flux [kg m-2 s-1]
    (computeNodeAtmosphericLatentSurfaceWaterFlux, heat.cpp:1013-1037)."""
    boundary_vapor, sat_c = boundary_vapor_concentration(boundary)
    return (boundary_vapor - sat_c) * aero_k


def heat_surface_water_sink(grid: Grid, params: SolverParameters,
                            heat: HeatState, boundary: HeatBoundary,
                            water, dt, conductances=None):
    """HeatSurface evaporative WATER flow [m3 s-1] (L, R, C), in the state
    dtype: the water solver's HeatSurface boundary branch
    (water.cpp:708-747), split between the ponded surface fraction and the
    bare soil, each bounded by the water it holds. ``water`` is a
    WaterState or a bare SIGNED-psi field (float32 on the fast path: the
    per-Picard-iteration form of the coupled step's boundary hook); ``dt``
    [s] a number or a 0-d tensor. Zero without ``heat_vapor``."""
    dev = grid.device
    if not params.heat_vapor:
        return torch.zeros(grid.shape, dtype=params.dtype, device=dev)

    psi = (water.h - grid.z) if isinstance(water, WaterState) else water
    dt = scalar(dt, params.dtype, dev)
    hs_mask = boundary.mask & grid.mask[1] & grid.mask[0]
    if conductances is not None:
        aero_k, soil_k = conductances
    else:
        aero_k, soil_k = surface_conductances(grid, params, heat, boundary,
                                              grid.z + psi)
    area = grid.area

    soil_evap = _div(atmospheric_latent_vapor_flux(
        grid, params, heat, boundary, psi, aero_k, soil_k), WATER_DENSITY) * area

    # surface water fraction (getNodeSurfaceWaterFraction,
    # soilPhysics.cpp:317-326)
    h_v = torch.clamp_min(psi[0], 0.0)
    h_0 = torch.clamp_min(grid.pond_max, 0.001)
    swf = torch.clamp_max(h_v / h_0, 1.0)

    surf_evap = _div(atmospheric_latent_surface_water_flux(boundary, aero_k),
                     WATER_DENSITY) * area * swf
    soil_evap = soil_evap * (1.0 - swf)
    # bound surface evaporation by the stored surface water volume
    surf_evap = torch.maximum(surf_evap, -_mul0(h_v, area) / dt)

    # bound soil evaporation by extractable/absorbable water content
    theta = _theta_layer1(grid, params, psi)
    theta_r = grid.soil.theta_r[1]
    theta_s = grid.soil.theta_s[1]
    vol1 = grid.volume[1]
    soil_evap = torch.where(
        soil_evap < 0,
        torch.maximum(soil_evap, -(theta - theta_r) * vol1 / dt),
        torch.minimum(soil_evap, (theta_s - theta_r) * vol1 / dt))

    sink = torch.zeros(grid.shape, dtype=params.dtype, device=dev)
    sink[0] = torch.where(hs_mask, surf_evap, 0.0)
    sink[1] = torch.where(hs_mask, soil_evap, 0.0)
    return sink


def update_boundary_heat(grid: Grid, params: SolverParameters,
                         heat: HeatState, boundary: HeatBoundary,
                         water: WaterState, dt_max: float, dt_water: float,
                         conductances, evap_rate):
    """Per-node heat flow [W] + Courant-limited dtHeat
    (updateBoundaryHeatData, heat.cpp:237-341): radiative + sensible +
    latent fluxes on the HeatSurface nodes; returns ``(heat_flow, dt_heat,
    fluxes_dict)`` with ``dt_heat`` a Python float. The Courant maximum is
    read on the host once; the dt arithmetic runs there in float64.
    ``conductances`` is the step's frozen (aero_k, soil_k) pair,
    ``evap_rate`` the water step's last HeatSurface boundary rate."""
    dt_max = float(dt_max)
    flow = W._set0(torch.where(grid.mask, heat.sink_source, 0.0), 0.0)

    # HeatSurface = layer-1 nodes with an atmosphere boundary
    hs_mask = boundary.mask & grid.mask[1]

    t_surf = heat.t[1]
    aero_k, _soil_k = conductances

    pressure = pressure_from_altitude(grid.z[1])
    delta_t = boundary.air_temperature - t_surf
    sensible = (air_volumetric_specific_heat(pressure, boundary.air_temperature)
                * delta_t * aero_k)
    radiative = boundary.net_irradiance

    # the latent flux is tied to the bounded evaporative water rate
    # (computeNodeAtmosphericLatentHeatFlux, heat.cpp:957-966)
    latent = (latent_vaporization_heat(t_surf - ZEROCELSIUS)
              * WATER_DENSITY * evap_rate / grid.area)
    # no advection: its term is 0
    advective = torch.zeros_like(sensible)

    flux_sum = (radiative + sensible + latent + advective) * grid.area
    flow[1] = torch.where(hs_mask, flow[1] + flux_sum, flow[1])

    # heat Courant |flux| dt / (C V) <= 1 over every heat node; the
    # capacity takes the TOTAL head as signed psi, the reference's quirk
    # (heat.cpp:295-297, DEVIATIONS #22)
    cap = heat_capacity(grid, params, water.h_old, heat.t_old,
                        with_vapor=params.heat_vapor)
    courant = torch.where(_heat_mask(grid),
                          torch.abs(flow) * dt_max
                          / (cap * torch.clamp_min(grid.volume, 1e-12)), 0.0)
    courant_max = host_read(courant.amax())

    if courant_max > 1.0 and dt_max > params.delta_t_min:
        dt_heat = max(params.delta_t_min, dt_max / max(courant_max, 1e-12))
    else:
        dt_heat = dt_max
    if dt_heat > 1.0:
        dt_heat = float(math.floor(dt_heat))
    return flow, dt_heat, dict(sensible=sensible, radiative=radiative,
                               aerodynamic_conductance=aero_k)


# ----------------------------------------------------------------------
# conduction assembly + solve (cpusolver.cpp:471-605)
# ----------------------------------------------------------------------

def _node_h_from_timesteps(water: WaterState, dt_heat, dt_water):
    """getNodeH_fromTimeSteps (heat.cpp:694-698); the dts [s] are numbers
    or 0-d tensors, taken as 0-d tensors of the state dtype."""
    h = water.h
    dth = scalar(dt_heat, h.dtype, h.device)
    dtw = scalar(dt_water, h.dtype, h.device)
    return water.h_old + (h - water.h_old) * dth / dtw


def _conduction_coeffs(grid: Grid, params: SolverParameters, heat: HeatState,
                       avg_h_signed, k_thermal):
    """a = area/dist * logmean(K_i, K_j) on every soil-soil link; returns
    ``(a_up, a_down, a_lat[8], heat_mask)``."""
    heat_mask = _heat_mask(grid)
    k0 = torch.clamp_min(k_thermal, 1e-12)

    # vertical
    k_above = torch.roll(k_thermal, 1, dims=0)
    mean_kv = compute_mean(k0, torch.clamp_min(k_above, 1e-12),
                           MeanType.LOGARITHMIC)
    a_up = mean_kv * grid.area / _vert_dist(grid)
    link_ok = heat_mask & torch.roll(heat_mask, 1, dims=0)
    link_ok[0] = False
    link_ok[1] = False   # layer 1 has no soil above
    a_up = torch.where(link_ok, a_up, 0.0)
    a_down = torch.roll(a_up, -1, dims=0)
    a_down[-1] = 0.0

    # lateral
    lat = []
    for idx, (di, dj) in enumerate(LATERAL_OFFSETS):
        nbr_ok = shift2d(heat_mask, di, dj, fill=False)
        k_nbr = torch.clamp_min(shift2d(k_thermal, di, dj), 1e-12)
        mean_k = compute_mean(k0, k_nbr, MeanType.LOGARITHMIC)
        a = mean_k * grid.lat_area / grid.lat_dist3d[idx]
        lat.append(torch.where(heat_mask & nbr_ok, a, 0.0))
    return a_up, a_down, torch.stack(lat), heat_mask


class SubstepInvariants(NamedTuple):
    """Sub-step-invariant fields of one boundary chunk, keyed on (dt_heat,
    dt_water): the retention evaluations computed once per chunk instead of
    once per sub-step (the same formulas and inputs, so the same values)."""

    h_signed64: torch.Tensor    # psi at the interpolated head [m], f64
    sens64: torch.Tensor        # sensible energy coefficient [J K-1], f64
    vfac64: torch.Tensor        # vapor volume factor [m3], f64
    # f32 assembly invariants
    theta_avg: torch.Tensor     # theta at the CN-averaged head
    theta_node: torch.Tensor    # theta at the interpolated head
    theta_old: torch.Tensor     # theta at the start-of-step head
    theta_link: torch.Tensor    # theta at the link-mean head


def energy_invariants(grid: Grid, params: SolverParameters,
                      water: WaterState, dt_heat, dt_water) -> SubstepInvariants:
    """Build :class:`SubstepInvariants` for one sub-step length."""
    node_h64 = _node_h_from_timesteps(water, dt_heat, dt_water)
    h_signed = node_h64 - grid.z
    theta = theta_from_signed_psi(grid, params, h_signed)
    bulk = estimate_bulk_density(grid)
    sens = ((_div(bulk, QUARTZ_DENSITY) * HEAT_CAPACITY_MINERAL
             + theta * HEAT_CAPACITY_WATER) * grid.volume)
    vfac = torch.clamp_min(grid.soil.theta_s - theta, 0.0) * grid.volume

    sd = params.sweep_dtype
    g = grid.astype(sd)
    node_h = node_h64.to(sd)
    h_old_s = water.h_old.to(sd)
    avg_h = (0.5 * (water.h_old + node_h64) - grid.z).to(sd)
    theta_avg = theta_from_signed_psi(g, params, avg_h)
    theta_node = theta_from_signed_psi(g, params, node_h - g.z)
    theta_old = theta_from_signed_psi(g, params, h_old_s - g.z)
    link_h = compute_mean(node_h, h_old_s, MeanType.ARITHMETIC) - g.z
    theta_link = theta_from_signed_psi(g, params, link_h)
    return SubstepInvariants(h_signed, sens, vfac, theta_avg, theta_node,
                             theta_old, theta_link)


def _storage_from_invariants(params: SolverParameters, inv: SubstepInvariants,
                             t_new, heat_mask):
    """Heat storage [J] from hoisted invariants: the sensible part in
    float64, the small vapor part evaluated in float32 and summed in
    float64."""
    h_signed, sens, vfac = inv.h_signed64, inv.sens64, inv.vfac64
    t64 = t_new.to(torch.float64)
    storage = torch.where(heat_mask, sens * t64, 0.0).sum()
    if params.heat_vapor:
        h32 = h_signed.to(torch.float32)
        t32 = t_new.to(torch.float32)
        v32 = _div(vapor_from_psi_temp(h32, t32), WATER_DENSITY)
        e32 = v32 * (HEAT_CAPACITY_AIR * t32
                     + latent_vaporization_heat(t32 - ZEROCELSIUS)
                     * WATER_DENSITY)
        storage = storage + torch.where(heat_mask, e32 * vfac.to(torch.float32), 0.0).sum(
            dtype=precision.accumulator())
    return storage


def heat_jacobi_solve(b_p, c_up, c_down, c_lat, mask, x0, max_iter: int, tol):
    """Jacobi sweeps on the preconditioned heat system until the max-norm
    of the update falls below ``tol`` or ``max_iter`` sweeps ran (the
    ``lax.while_loop`` of heat_step, heat.py:1076-1095); one host read per
    sweep, the comparison in float32. Returns ``(x, sweeps)``;
    ``heat_jacobi_solve.sweeps`` counts every sweep run (reset it to 0
    before a run)."""
    tol = np.float32(tol)
    x, it, norm = x0, 0, np.float32(np.inf)
    while it < max_iter and norm >= tol:
        acc = (b_p + c_up * torch.roll(x, 1, dims=0)
               + c_down * torch.roll(x, -1, dims=0))
        for idx, (di, dj) in enumerate(LATERAL_OFFSETS):
            acc = acc + c_lat[idx] * shift2d(x, di, dj)
        x_new = torch.where(mask, acc, x)
        norm = np.float32(host_read(torch.abs(x_new - x).amax()))
        x, it = x_new, it + 1
    heat_jacobi_solve.sweeps += it
    return x, it


heat_jacobi_solve.sweeps = 0


def _balance(storage, storage_prev, flow_sum, dt_heat, params):
    """(sink, mbr, mbr on the host, accepted) of one sub-step
    (evaluateHeatBalance, heat.cpp:376-394); rejected only while
    dtHeat > 10 dtMin (cpusolver.cpp:585-596)."""
    sink = flow_sum * dt_heat
    mbe = (storage - storage_prev) - sink
    ref = torch.maximum(torch.abs(storage) * 1e-6, torch.abs(sink))
    mbr = mbe / torch.clamp_min(ref, 1.0)
    mbr_f = host_read(mbr)
    ok = abs(mbr_f) <= 1.0 or dt_heat <= params.delta_t_min * 10.0
    return sink, mbr, mbr_f, ok


# ----------------------------------------------------------------------
# heat_frozen_props: per-chunk frozen system
# ----------------------------------------------------------------------

class FrozenChunkSystem(NamedTuple):
    """Per-chunk frozen heat system factors (params.heat_frozen_props):
    everything T-dependent evaluated once per boundary chunk at the
    chunk-start temperatures, stored without the 1/dt terms so every
    sub-step length folds its dt in with a few element-wise passes."""

    heat_mask: torch.Tensor
    aw_up: torch.Tensor         # implicit CN couplings a*wf
    aw_down: torch.Tensor
    aw_lat: torch.Tensor
    ae_up: torch.Tensor         # explicit CN couplings a*(1-wf)
    ae_down: torch.Tensor
    ae_lat: torch.Tensor
    adiag: torch.Tensor         # sum_a*wf (diag without cap/dt)
    cap: torch.Tensor           # heat capacity x volume [J K-1]
    const0: torch.Tensor        # hf + iso_latent [W]
    corr_rate: torch.Tensor     # advected-energy correction RATE [W]
    inv: SubstepInvariants
    flow_sum: torch.Tensor
    tol: np.float32


def chunk_frozen_system(grid: Grid, params: SolverParameters,
                        t_chunk: torch.Tensor, water: WaterState,
                        dt_heat: float, dt_water: float, heat_flow, flow_sum,
                        inv: SubstepInvariants) -> FrozenChunkSystem:
    """Assemble the frozen factors: the heat sub-step's assembly with
    ``t_cur = t_prev = t_chunk`` and the chunk-dt interpolated head."""
    wf = params.heat_weight_factor
    sd = params.sweep_dtype
    node_h64 = _node_h_from_timesteps(water, dt_heat, dt_water)

    g = grid.astype(sd)
    t_cur = t_chunk.to(sd)
    node_h = node_h64.to(sd)
    h_old_s = water.h_old.to(sd)
    avg_h = (0.5 * (water.h_old + node_h64) - grid.z).to(sd)
    hf = heat_flow.to(sd)
    tol = max(np.float32(params.residual_tolerance), np.float32(1e-5))

    th_avg = inv.theta_avg
    cap = heat_capacity(g, params, avg_h, t_cur,
                        with_vapor=params.heat_vapor, theta=th_avg) * g.volume
    k_thermal = soil_thermal_conductivity(g, params, t_cur, avg_h,
                                          with_vapor=True, theta=th_avg)
    heat_pseudo = HeatState(t=t_chunk, t_old=t_chunk, sink_source=None,
                            storage_prev=None, storage_whole=None,
                            sink_whole=None, mbr=None)
    a_up, a_down, a_lat, heat_mask = _conduction_coeffs(
        g, params, heat_pseudo, avg_h, k_thermal)

    theta_new, theta_old = inv.theta_node, inv.theta_old
    d_theta = theta_new - theta_old
    heat_cap_corr = d_theta * HEAT_CAPACITY_WATER * t_cur
    if params.heat_vapor:
        v_new = (_div(vapor_from_psi_temp(node_h - g.z, t_cur), WATER_DENSITY)
                 * torch.clamp_min(g.soil.theta_s - theta_new, 0.0))
        v_old = (_div(vapor_from_psi_temp(h_old_s - g.z, t_cur), WATER_DENSITY)
                 * torch.clamp_min(g.soil.theta_s - theta_old, 0.0))
        d_theta_v = v_new - v_old
        heat_cap_corr = (heat_cap_corr + d_theta_v * HEAT_CAPACITY_AIR * t_cur
                         + d_theta_v * latent_vaporization_heat(t_cur - ZEROCELSIUS)
                         * WATER_DENSITY)
    heat_cap_corr = heat_cap_corr * g.volume

    sum_a = a_up + a_down + W._sum_lateral(a_lat)

    const0 = hf
    if params.heat_vapor:
        const0 = const0 + isothermal_latent_link_flux(
            g, params, heat_pseudo, water, node_h,
            t_field=t_cur, h_old=h_old_s, theta=inv.theta_link)

    return FrozenChunkSystem(
        heat_mask=heat_mask,
        aw_up=a_up * wf,
        aw_down=a_down * wf,
        aw_lat=a_lat * wf,
        ae_up=a_up * (1.0 - wf),
        ae_down=a_down * (1.0 - wf),
        ae_lat=a_lat * (1.0 - wf),
        adiag=sum_a * wf,
        cap=cap, const0=const0,
        corr_rate=heat_cap_corr / scalar(dt_heat, cap.dtype, cap.device),
        inv=inv, flow_sum=flow_sum, tol=tol)


def heat_substep_frozen(grid: Grid, params: SolverParameters,
                        fz: FrozenChunkSystem, t_field: torch.Tensor,
                        storage_prev, sink_whole, dt_heat: float):
    """One sub-step over a frozen chunk system: fold the sub-step dt in,
    the RHS from the current T, Jacobi sweeps, the float64 balance and the
    accept decision. Returns ``(t, storage_prev, sink_whole, mbr, ok)``
    with ``ok`` a bool decided on the host."""
    mask = fz.heat_mask
    b_p, c_up, c_down, c_lat, t0 = _fold_dt(params, fz, t_field, dt_heat)
    max_iter = params.max_iterations_for(params.max_approximations - 1)
    x, _ = heat_jacobi_solve(b_p, c_up, c_down, c_lat, mask, t0, max_iter, fz.tol)
    t_new = torch.where(mask, x.to(t_field.dtype), t_field)
    storage = _storage_from_invariants(params, fz.inv, t_new, mask)
    sink, mbr, _, ok = _balance(storage, storage_prev, fz.flow_sum, dt_heat, params)
    if ok:
        return t_new, storage, sink_whole + sink, mbr, True
    return t_field, storage_prev, sink_whole, mbr, False


def _fold_dt(params: SolverParameters, fz: FrozenChunkSystem, t_field,
             dt_heat: float):
    """The preconditioned system ``(b_p, c_up, c_down, c_lat)`` of
    a sub-step of ``dt_heat`` over a frozen chunk system, and the sweeps'
    start."""
    mask = fz.heat_mask
    t0 = t_field.to(params.sweep_dtype)
    dth = scalar(dt_heat, t0.dtype, t0.device)
    cap_dt = fz.cap / dth
    diag = torch.where(mask, fz.adiag + cap_dt, 1.0)
    inv_diag = torch.where(diag > 0, 1.0 / diag, 1.0)
    c_up = fz.aw_up * inv_diag
    c_down = fz.aw_down * inv_diag
    c_lat = fz.aw_lat * inv_diag[None]

    f0 = (fz.ae_up * (torch.roll(t0, 1, dims=0) - t0)
          + fz.ae_down * (torch.roll(t0, -1, dims=0) - t0))
    for idx, (di, dj) in enumerate(LATERAL_OFFSETS):
        f0 = f0 + fz.ae_lat[idx] * (shift2d(t0, di, dj) - t0)
    b = cap_dt * t0 + fz.const0 - fz.corr_rate + f0
    b_p = torch.where(mask, b * inv_diag, 0.0)
    return b_p, c_up, c_down, c_lat, t0


def _node_heat_energy(grid: Grid, params: SolverParameters, h_signed, t_k):
    """Per-node heat energy [J] (getNodeHeatStorage,
    soilFluxes3D.cpp:1545-1567): sensible capacity x T, plus the latent
    energy of the soil air's vapor with ``heat_vapor``."""
    cap = heat_capacity(grid, params, h_signed, t_k,
                        with_vapor=params.heat_vapor)
    energy = cap * grid.volume * t_k
    if params.heat_vapor:
        theta = theta_from_signed_psi(grid, params, h_signed)
        theta_v = (_div(vapor_from_psi_temp(h_signed, t_k), WATER_DENSITY)
                   * torch.clamp_min(grid.soil.theta_s - theta, 0.0))
        energy = energy + (theta_v * latent_vaporization_heat(t_k - ZEROCELSIUS)
                           * WATER_DENSITY * grid.volume)
    return energy


def heat_storage(grid: Grid, params: SolverParameters, heat: HeatState,
                 water: WaterState):
    """Total heat storage [J] (computeCurrentHeatStorage, heat.cpp:344-357)."""
    return _masked_sum(_heat_mask(grid),
                       _node_heat_energy(grid, params, water.h - grid.z, heat.t))

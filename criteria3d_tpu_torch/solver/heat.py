"""Coupled soil heat transport: diffusion + latent (vapor) + advective terms.

PyTorch counterpart of ``criteria3d_tpu/solver/heat.py`` (the reference's
agrolib/soilFluxes3D/heat.cpp): Crank-Nicolson-weighted conduction on the
water solver's stencil, the de Vries/Campbell soil thermal conductivity,
Philip-de Vries vapor conductivities, the atmospheric surface energy
balance boundary and the heat sub-step with its Jacobi sweeps, in the exact
float64 form and the float32 ("fast") form with a float64 balance, plus the
chunk-frozen system of ``heat_frozen_props``. Every function evaluates the
same expressions, in the same order and dtypes, as its JAX twin.

The dtype rules of solver/water.py and ops.py hold here too: a 0-d float64 tensor
times a float32 tensor is float64 in JAX but float32 in torch, so such
products cast first (:func:`_mul0`); and a tensor is divided by a Python
constant through a 0-d tensor of its own dtype (:func:`_div`, :func:`_rdiv`),
because CUDA turns division by a host scalar into multiplication by its
rounded reciprocal, and torch turns ``c / tensor`` into ``c *
reciprocal(tensor)``. Integer powers are products (JAX lowers ``x ** 2`` and
``x ** 4`` to multiplications); other powers go through
:func:`criteria3d_tpu_torch.core.soil.power`.

The decisions of the coupled sub-stepping have device forms that the
coupled period's state machine (solver/coupled.py) runs as its units, with
no host read: the chunk's Courant-limited ``dt_heat``
(:func:`boundary_heat`), one Jacobi sweep with its max-norm
(:func:`heat_sweep`, the body of JAX's sweep ``lax.while_loop``; each
sweep counted in ``heat_jacobi_solve.sweeps`` through ``device.tally``),
its stop test (:func:`sweep_goes_on`, in the system's dtype) and the
sub-step's balance with its accept flag (:func:`substep_balance`). Time-step
lengths are 0-d float64 tensors there, with the IEEE operations JAX does
in the same order. The public functions that return host values
(:func:`update_boundary_heat`'s ``dt_heat``, :func:`heat_jacobi_solve`'s
loop, :func:`heat_step`'s MBR, :func:`heat_substep_frozen`'s flag) read
them once a call, a sweep, or a sub-step through ``device.host_read``.

On a mesh (``SolverParameters.mesh``; grid, states and boundary cut by
``shard_pytree``) the functions that take a grid run their per-cell
arithmetic once per grown block through
:func:`~criteria3d_tpu_torch.parallel.sharding.bmap`, unchanged, as
solver/step.py runs the water step: every global sum or maximum is a
per-block partial over owned cells combined on ``mesh.home`` before its
host read, and every stencil reads fresh rings. The stencil inputs (T, h,
h_old, k, the boundary flow) are per-node fields whose rings are fresh at
a sub-step's start, so each coefficient is exact on all but the outer
ring cell; the sweeps exchange x once every ``RING`` sweeps and at the
end. The hook functions the water step calls per block
(:func:`thermal_water_flux`, :func:`heat_surface_water_sink`) take one
block's (or the whole box's) tensors.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from criteria3d_tpu_torch.constants import (GRAVITY, MH2O, R_GAS,
                                            VON_KARMAN, WATER_DENSITY,
                                            ZEROCELSIUS)
from criteria3d_tpu_torch.core.grid import BoundaryType, Grid
from criteria3d_tpu_torch.core.soil import (MeanType, compute_mean, power,
                                            se_from_psi, theta_from_se)
from criteria3d_tpu_torch.core.state import SolverParameters, WaterState
from criteria3d_tpu_torch.device import (host_read, map_tensors,
                                         resolve_device, scalar, tally)
from criteria3d_tpu_torch.ops import div as _div
from criteria3d_tpu_torch.ops import mul0 as _mul0
from criteria3d_tpu_torch.ops import rdiv as _rdiv
from criteria3d_tpu_torch.ops import sq as _sq
from criteria3d_tpu_torch.parallel.sharding import (block_max, block_sum,
                                                    blocks_of, bmap, combine,
                                                    exchange, first_block,
                                                    holds_home, owned, unzip)
from criteria3d_tpu_torch.physics.meteo import (
    P0, pressure_from_altitude, saturation_vapor_pressure,
    vapor_concentration_from_pressure)
from criteria3d_tpu_torch.physics.meteo import (
    latent_heat_vaporization as latent_vaporization_heat)
from criteria3d_tpu_torch.solver import water as W
from criteria3d_tpu_torch.solver.step import _is_fast, _ring
from criteria3d_tpu_torch.solver.shifts import LATERAL_OFFSETS, shift2d

__all__ = ["HeatState", "HeatBoundary", "heat_capacity",
           "soil_thermal_conductivity", "heat_step", "initialize_heat",
           "heat_storage", "update_boundary_heat", "heat_surface_water_sink",
           "thermal_water_flux", "surface_conductances",
           "chunk_frozen_system", "heat_substep_frozen", "energy_invariants",
           "heat_jacobi_solve", "boundary_heat", "boundary_heat_parts",
           "masked_parts", "chunk_dt", "heat_system",
           "fold_dt", "heat_sweep", "sweep_goes_on", "sweep_budget",
           "heat_tolerance", "substep_balance", "substep_end", "accept_substep",
           "HEAT_ASSEMBLE_RANGE", "HEAT_SOLVE_RANGE"]

# torch.profiler ranges of the heat sub-stepping: property assembly, chunk
# system and dt fold; the Jacobi sweeps (chip_smoke.py reads them)
HEAT_ASSEMBLE_RANGE = "c3d.heat_assemble"
HEAT_SOLVE_RANGE = "c3d.heat_solve"

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


def masked_parts(mask, field):
    """The partials of :func:`_masked_sum`: each block's sum of ``field``
    over the owned cells of ``mask`` (one sum on a whole box)."""
    ring = _ring(field)
    return bmap(lambda m, f: owned(torch.where(m, f, 0.0), ring).sum(), mask, field)


def _masked_sum(mask, field):
    """The sum of ``field`` over the cells of ``mask``: per block over its
    owned cells, added on ``mesh.home`` (one sum on a whole box)."""
    return block_sum(masked_parts(mask, field))


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

    def to(self, device) -> "HeatState":
        return map_tensors(self, lambda t: t.to(device))


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

    def to(self, device) -> "HeatBoundary":
        return map_tensors(self, lambda t: t.to(device))

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


def thermal_water_invariant_flux(grid: Grid, params: SolverParameters,
                                 heat: HeatState, water: WaterState):
    """Temperature-gradient water flows [m3 s-1] at the start-of-step
    state (computeLinkFluxes, water.cpp:329-341)."""
    return thermal_water_flux(grid, params, heat, water.h - grid.z, water.k)


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


def advective_link_coefficients(grid: Grid, params: SolverParameters,
                                heat: HeatState, water: WaterState,
                                node_h):
    """Implicit-upwind advective heat-exchange coefficients [W K-1] from
    the physical per-link water fluxes, in enthalpy form referenced to
    0 degC (the JAX package's deviation from the reference's explicit
    preconditioned-value scheme, computeAdvectiveFlux heat.cpp:606-621;
    DEVIATIONS.md). Returns ``(adv_up, adv_down, adv_lat[8], adv_diag,
    adv_b)``; includes the isothermal vapor advection with
    ``heat_vapor``."""
    heat_mask = _heat_mask(grid)
    avg_h = compute_mean(node_h, water.h_old, MeanType.ARITHMETIC)
    zero = torch.zeros_like(avg_h)

    # --- per-direction inflow-positive liquid fluxes [m3 s-1] ---
    k = water.k
    k_above = torch.roll(k, 1, dims=0)
    mean_kv = compute_mean(torch.clamp_min(k, 1e-30),
                           torch.clamp_min(k_above, 1e-30), params.mean_type)
    dist_v = _vert_dist(grid)
    a_up = mean_kv * grid.area / dist_v
    up_ok = heat_mask & torch.roll(heat_mask, 1, dims=0)
    up_ok[0] = False
    up_ok[1] = False
    q_up = torch.where(up_ok, a_up * (torch.roll(avg_h, 1, dims=0) - avg_h), 0.0)
    down_ok = heat_mask & torch.roll(heat_mask, -1, dims=0)
    down_ok[-1] = False
    q_down = torch.where(down_ok,
                         torch.roll(a_up, -1, dims=0)
                         * (torch.roll(avg_h, -1, dims=0) - avg_h), 0.0)

    k_lat = torch.clamp_min(k * params.lateral_vertical_ratio, 1e-30)
    nbr_oks = [heat_mask & shift2d(heat_mask, di, dj, fill=False)
               for (di, dj) in LATERAL_OFFSETS]
    q_lat = []
    for idx, (di, dj) in enumerate(LATERAL_OFFSETS):
        mean_k = compute_mean(k_lat, torch.clamp_min(shift2d(k_lat, di, dj), 1e-30),
                              params.mean_type)
        a = mean_k * grid.lat_area / grid.lat_dist3d[idx]
        q_lat.append(torch.where(nbr_oks[idx],
                                 a * (shift2d(avg_h, di, dj) - avg_h), 0.0))

    # --- vapor mass fluxes [kg s-1] ---
    if params.heat_vapor:
        psi_e = (avg_h - grid.z) * GRAVITY      # [J kg-1]
        ivk = isothermal_vapor_conductivity(grid, params, heat.t, avg_h - grid.z)
        ivk0 = torch.clamp_min(ivk, 1e-30)
        mean_iv = compute_mean(ivk0, torch.clamp_min(torch.roll(ivk, 1, dims=0), 1e-30),
                               params.mean_type)
        qv_up = torch.where(up_ok, mean_iv * (torch.roll(psi_e, 1, dims=0)
                                              - psi_e) / dist_v * grid.area, 0.0)
        qv_down = torch.where(
            down_ok,
            torch.roll(mean_iv, -1, dims=0)
            * (torch.roll(psi_e, -1, dims=0) - psi_e)
            / torch.roll(dist_v, -1, dims=0) * grid.area, 0.0)
        qv_lat = []
        for idx, (di, dj) in enumerate(LATERAL_OFFSETS):
            mean_v = compute_mean(ivk0, torch.clamp_min(shift2d(ivk, di, dj), 1e-30),
                                  params.mean_type)
            qv_lat.append(torch.where(
                nbr_oks[idx], mean_v * (shift2d(psi_e, di, dj) - psi_e)
                / grid.lat_dist3d[idx] * grid.lat_area, 0.0))
    else:
        qv_up = qv_down = zero
        qv_lat = [zero] * len(LATERAL_OFFSETS)

    def coeff(q_liq, q_vap):
        """(inflow, outflow) upwind couplings [W K-1] for one link."""
        cin = (HEAT_CAPACITY_WATER * torch.clamp_min(q_liq, 0.0)
               + HEAT_CAPACITY_WATER_VAPOR * torch.clamp_min(q_vap, 0.0))
        cout = (HEAT_CAPACITY_WATER * torch.clamp_min(-q_liq, 0.0)
                + HEAT_CAPACITY_WATER_VAPOR * torch.clamp_min(-q_vap, 0.0))
        return cin, cout

    adv_up, out_up = coeff(q_up, qv_up)
    adv_down, out_down = coeff(q_down, qv_down)
    adv_lat, adv_diag = [], out_up + out_down
    cin_sum = adv_up + adv_down
    for idx in range(len(LATERAL_OFFSETS)):
        cin, cout = coeff(q_lat[idx], qv_lat[idx])
        adv_lat.append(cin)
        adv_diag = adv_diag + cout
        cin_sum = cin_sum + cin
    adv_b = ZEROCELSIUS * (adv_diag - cin_sum)
    return adv_up, adv_down, torch.stack(adv_lat), adv_diag, adv_b


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
    computeStep (updateConductance, heat.cpp:214-236). On a mesh a
    Blocked of per-block pairs."""
    def block(g, heat, boundary, h):
        aero_k = aerodynamic_conductance(boundary, heat.t[1])
        theta_top = _theta_layer1(g, params, h - g.z)
        soil_k = 1.0 / soil_surface_resistance(theta_top)
        return aero_k, soil_k
    return bmap(block, grid, blocks_of(heat), blocks_of(boundary), h)


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
                         water: WaterState, dt_max, dt_water=None,
                         conductances=None, evap_rate=None):
    """Per-node heat flow [W] + Courant-limited dtHeat
    (updateBoundaryHeatData, heat.cpp:237-341): :func:`boundary_heat` with
    ``dt_heat`` read on the host as a Python float (one host read).
    ``dt_max`` and ``dt_water`` [s] are numbers or 0-d tensors; returns
    ``(heat_flow, dt_heat, fluxes_dict)``."""
    flow, dt_heat, fluxes = boundary_heat(grid, params, heat, boundary, water, dt_max,
                                          dt_water, conductances, evap_rate)
    return flow, float(host_read(dt_heat)), fluxes


def boundary_heat(grid: Grid, params: SolverParameters, heat: HeatState,
                  boundary: HeatBoundary, water: WaterState, dt_max, dt_water=None,
                  conductances=None, evap_rate=None):
    """Per-node heat flow [W] of radiative + sensible + (heat_vapor) latent
    + (heat_advection) advective fluxes on the HeatSurface nodes, and the
    Courant-limited dtHeat, on the device: returns ``(heat_flow, dt_heat,
    fluxes_dict)`` with ``dt_heat`` a 0-d float64 tensor on the home
    device. The Courant maximum is the maximum of the blocks' owned-cell
    maxima on a mesh; :func:`chunk_dt` limits ``dt_max`` by it with JAX's
    float64 operations. ``dt_max`` and ``dt_water`` (``dt_max`` when None)
    [s] are numbers or 0-d tensors. ``conductances`` is the step's frozen
    (aero_k, soil_k) pair, ``evap_rate`` the water step's last HeatSurface
    boundary rate. On a mesh the flow and the dict are Blocked."""
    flow, courant, fluxes = boundary_heat_parts(grid, params, heat, boundary, water,
                                                dt_max, dt_water, conductances, evap_rate)
    return flow, chunk_dt(params, block_max(courant), dt_max), fluxes


def boundary_heat_parts(grid: Grid, params: SolverParameters, heat: HeatState,
                        boundary: HeatBoundary, water: WaterState, dt_max,
                        dt_water=None, conductances=None, evap_rate=None):
    """:func:`boundary_heat` before its join: ``(heat_flow, courant,
    fluxes_dict)``, ``courant`` the blocks' owned-cell Courant maxima (the
    whole box's maximum without a mesh), whose maximum :func:`chunk_dt`
    reads; a caller joins it with other partials (solver/coupled.py's
    chunk, with the flow's sum)."""
    dt_water = dt_max if dt_water is None else dt_water
    ring = _ring(grid)
    return unzip(bmap(
        lambda g, hs, bd, w, cd, er: _boundary_heat_block(
            g, params, hs, bd, w, dt_max, dt_water, cd, er, ring),
        grid, blocks_of(heat), blocks_of(boundary), blocks_of(water),
        conductances, evap_rate))


def chunk_dt(params: SolverParameters, courant_max: torch.Tensor, dt_max):
    """The chunk's dtHeat (heat.cpp:292-341; JAX heat.py:787-796): ``dt_max``
    cut to ``max(dtMin, dt_max / max(courant, 1e-12))`` where the Courant
    maximum passes 1 and dt_max passes dtMin, then floored above 1 s; a 0-d
    tensor of the Courant maximum's dtype (float64) on its device."""
    dt_max = scalar(dt_max, courant_max.dtype, courant_max.device)
    cut = (courant_max > 1.0) & (dt_max > params.delta_t_min)
    dt_heat = torch.where(cut, torch.clamp_min(
        dt_max / torch.clamp_min(courant_max, 1e-12), params.delta_t_min), dt_max)
    return torch.where(dt_heat > 1.0, torch.floor(dt_heat), dt_heat)


def _boundary_heat_block(grid: Grid, params: SolverParameters, heat: HeatState,
                         boundary: HeatBoundary, water: WaterState, dt_max,
                         dt_water, conductances, evap_rate, ring: int):
    """:func:`update_boundary_heat` on one block (or the whole box): the
    heat flow [W], the maximum Courant number of the owned heat nodes and
    the surface fluxes."""
    L = grid.n_layers
    flow = W._set0(torch.where(grid.mask, heat.sink_source, 0.0), 0.0)

    # HeatSurface = layer-1 nodes with an atmosphere boundary
    hs_mask = boundary.mask & grid.mask[1] if L > 1 else boundary.mask

    t_surf = heat.t[1]
    if conductances is None:
        conductances = surface_conductances(grid, params, heat, boundary,
                                            water.h)
    aero_k, _soil_k = conductances

    pressure = pressure_from_altitude(grid.z[1])
    delta_t = boundary.air_temperature - t_surf
    sensible = (air_volumetric_specific_heat(pressure, boundary.air_temperature)
                * delta_t * aero_k)
    radiative = boundary.net_irradiance

    latent = torch.zeros_like(sensible)
    advective = torch.zeros_like(sensible)
    if params.heat_vapor:
        # the latent flux is tied to the bounded evaporative water rate
        # (computeNodeAtmosphericLatentHeatFlux, heat.cpp:957-966)
        if evap_rate is None:
            evap_rate = heat_surface_water_sink(grid, params, heat, boundary,
                                                water, dt_water,
                                                conductances=conductances)[1]
        latent = (latent_vaporization_heat(t_surf - ZEROCELSIUS)
                  * WATER_DENSITY * evap_rate / grid.area)
    if params.heat_advection:
        # advected heat of the infiltrating water (heat.cpp:276-280),
        # reconstructed with the WATER step's dt
        wflow = torch.where(grid.mask, water.sink_source, 0.0)
        a01 = W._vertical_conductance(grid, params, water.h, water.h_old,
                                      water.k, wflow, dt_water)[1]
        avg_h_w = 0.5 * (water.h + water.h_old)
        q_inf = a01 * (avg_h_w[0] - avg_h_w[1])      # [m3 s-1], >0 into soil
        adv_t_inf = torch.where(q_inf > 0.0, boundary.air_temperature,
                                heat.t[1])
        advective = (q_inf * HEAT_CAPACITY_WATER
                     * (adv_t_inf - ZEROCELSIUS) / grid.area)
        # advected heat of the evaporative/condensing vapor flow
        # (heat.cpp:282-286)
        if params.heat_vapor:
            evap_sink = heat_surface_water_sink(grid, params, heat,
                                                boundary, water, dt_water,
                                                conductances=conductances)
            evap = evap_sink[0] + evap_sink[1]          # [m3 s-1]
            adv_t = torch.where(evap < 0.0, heat.t[1],
                                boundary.air_temperature)
            advective = advective + (evap * WATER_DENSITY
                                     * HEAT_CAPACITY_WATER_VAPOR
                                     * (adv_t - ZEROCELSIUS) / grid.area)

    flux_sum = (radiative + sensible + latent + advective) * grid.area
    flow[1] = torch.where(hs_mask, flow[1] + flux_sum, flow[1])

    # FreeDrainage / PrescribedTotalPotential advective outflow
    # (heat.cpp:300-305): draining water carries its node's 0 degC-
    # referenced enthalpy out
    if params.heat_advection:
        _, brate = W.update_boundary_water(
            grid, params, water.h, water.h_old, water.k, water.sink_source,
            water.pond, dt_water)
        adv_bt = ((grid.btype == BoundaryType.FREE_DRAINAGE)
                  | (grid.btype == BoundaryType.PRESCRIBED_TOTAL_POTENTIAL))
        drain_adv = torch.where(
            _heat_mask(grid) & adv_bt & (brate < 0.0),
            brate * HEAT_CAPACITY_WATER * (heat.t - ZEROCELSIUS), 0.0)
        flow = flow + drain_adv

    # heat Courant |flux| dt / (C V) <= 1 over every heat node; the
    # capacity takes the TOTAL head as signed psi, the reference's quirk
    # (heat.cpp:295-297, DEVIATIONS #22)
    cap = heat_capacity(grid, params, water.h_old, heat.t_old,
                        with_vapor=params.heat_vapor)
    courant = torch.where(_heat_mask(grid),
                          torch.abs(flow) * scalar(dt_max, flow.dtype, flow.device)
                          / (cap * torch.clamp_min(grid.volume, 1e-12)), 0.0)
    return flow, owned(courant, ring).amax(), dict(
        sensible=sensible, radiative=radiative, aerodynamic_conductance=aero_k)


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


class HeatSystem(NamedTuple):
    b: torch.Tensor
    c_up: torch.Tensor
    c_down: torch.Tensor
    c_lat: torch.Tensor
    diag: torch.Tensor
    heat_mask: torch.Tensor


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
    """Sub-step-invariant fields of heat_step, keyed on (dt_heat,
    dt_water): the retention evaluations of one boundary chunk, computed
    once per chunk instead of once per sub-step (the same formulas and
    inputs, so the same values)."""

    h_signed64: torch.Tensor    # psi at the interpolated head [m], f64
    sens64: torch.Tensor        # sensible energy coefficient [J K-1], f64
    vfac64: torch.Tensor        # vapor volume factor [m3], f64
    # f32 assembly invariants (None on the f64 parity path)
    theta_avg: torch.Tensor | None     # theta at the CN-averaged head
    theta_node: torch.Tensor | None    # theta at the interpolated head
    theta_old: torch.Tensor | None     # theta at the start-of-step head
    theta_link: torch.Tensor | None    # theta at the link-mean head


def energy_invariants(grid: Grid, params: SolverParameters,
                      water: WaterState, dt_heat, dt_water):
    """Build :class:`SubstepInvariants` for one sub-step length (on a mesh
    a Blocked of per-block ones)."""
    return bmap(lambda g, w: _energy_invariants(g, params, w, dt_heat, dt_water),
                grid, blocks_of(water))


def _energy_invariants(grid: Grid, params: SolverParameters,
                       water: WaterState, dt_heat, dt_water):
    node_h64 = _node_h_from_timesteps(water, dt_heat, dt_water)
    h_signed = node_h64 - grid.z
    theta = theta_from_signed_psi(grid, params, h_signed)
    bulk = estimate_bulk_density(grid)
    sens = ((_div(bulk, QUARTZ_DENSITY) * HEAT_CAPACITY_MINERAL
             + theta * HEAT_CAPACITY_WATER) * grid.volume)
    vfac = torch.clamp_min(grid.soil.theta_s - theta, 0.0) * grid.volume

    theta_avg = theta_node = theta_old = theta_link = None
    if _is_fast(params):
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


def _storage_from_invariants(grid: Grid, params: SolverParameters,
                             inv, t_new, heat_mask):
    """Heat storage [J] from hoisted invariants: the sensible part in
    float64, the small vapor part evaluated in float32 and summed in
    float64, as in JAX; on a mesh each part a sum of per-block float64
    partials over owned cells, both parts in one join."""
    ring = _ring(t_new)

    def parts(inv, t_new, heat_mask):
        h_signed, sens, vfac = inv.h_signed64, inv.sens64, inv.vfac64
        t64 = t_new.to(torch.float64)
        out = [owned(torch.where(heat_mask, sens * t64, 0.0), ring).sum()]
        if params.heat_vapor:
            h32 = h_signed.to(torch.float32)
            t32 = t_new.to(torch.float32)
            v32 = _div(vapor_from_psi_temp(h32, t32), WATER_DENSITY)
            e32 = v32 * (HEAT_CAPACITY_AIR * t32
                         + latent_vaporization_heat(t32 - ZEROCELSIUS)
                         * WATER_DENSITY)
            out.append(owned(torch.where(heat_mask, e32 * vfac.to(torch.float32), 0.0),
                             ring).sum(dtype=torch.float64))
        return tuple(out)
    _, *sums = combine(sums=unzip(bmap(parts, inv, t_new, heat_mask)))
    return sums[0] if len(sums) == 1 else sums[0] + sums[1]


def heat_jacobi_solve(b_p, c_up, c_down, c_lat, mask, x0, max_iter: int, tol):
    """Jacobi sweeps on the preconditioned heat system until the max-norm
    of the update falls below ``tol`` or ``max_iter`` sweeps ran (the
    ``lax.while_loop`` of heat_step, heat.py:1076-1095): a loop over
    :func:`heat_sweep` for callers outside the coupled period's machine,
    with one host read per sweep and :func:`sweep_goes_on`'s test in the
    system's dtype. Returns ``(x, sweeps)``; ``heat_jacobi_solve.sweeps``
    counts every sweep run (reset it to 0 before a run).

    On a mesh every argument is blocked: each block sweeps its grown
    tile, the norm is the maximum of the blocks' owned-cell maxima in the
    system's dtype (the same number as the whole box's: a maximum does
    not depend on order), and x's rings are refreshed once every ``RING``
    sweeps and at the end (after s <= RING sweeps only the outer s ring
    cells are stale), so x leaves with fresh rings."""
    ring = _ring(x0)
    tol = scalar(float(tol), first_block(x0).dtype, x0.mesh.home if ring else x0.device)
    system = (b_p, c_up, c_down, c_lat, mask)
    x, it, stale, go = x0, 0, 0, max_iter > 0
    while go:
        x, norm = heat_sweep(system, x)
        it, stale = it + 1, stale + 1
        go = bool(host_read(sweep_goes_on(it, max_iter, norm, tol)))
        if ring and (stale == ring or not go):
            x, stale = exchange(x), 0
    return x, it


heat_jacobi_solve.sweeps = 0


def heat_sweep(system, x):
    """One Jacobi sweep of the preconditioned heat system ``(b_p, c_up,
    c_down, c_lat, mask)`` from ``x``: ``(x_new, norm)``, the norm the
    max-norm of the update in the system's dtype on the home device (on a
    mesh the maximum of the blocks' owned-cell maxima; the caller refreshes
    the rings). Counted in ``heat_jacobi_solve.sweeps`` (``device.tally``:
    on the card under a CUDA graph, a count on the card; on a mesh run by
    several machines, by the machine holding block (0, 0))."""
    ring = _ring(x)

    def sweep(b_p, c_up, c_down, c_lat, mask, x):
        acc = (b_p + c_up * torch.roll(x, 1, dims=0)
               + c_down * torch.roll(x, -1, dims=0))
        for idx, (di, dj) in enumerate(LATERAL_OFFSETS):
            acc = acc + c_lat[idx] * shift2d(x, di, dj)
        x_new = torch.where(mask, acc, x)
        return x_new, owned(torch.abs(x_new - x), ring).amax()

    x_new, part = unzip(bmap(sweep, *system, x))
    norm = block_max(part)
    if holds_home(x):
        tally(heat_jacobi_solve, "sweeps", norm.device)
    return x_new, norm


def sweep_goes_on(it, max_iter: int, norm, tol):
    """The sweep loop's test after ``it`` sweeps (JAX's ``cond``): fewer than
    ``max_iter`` sweeps and the last norm at or above ``tol``, compared in
    the system's dtype; a 0-d bool tensor."""
    return (norm >= tol) & (it < max_iter)


def substep_balance(storage, storage_prev, flow_sum, dt_heat, params):
    """(sink, mbr, accepted) of one sub-step (evaluateHeatBalance,
    heat.cpp:376-394), 0-d tensors on the device; rejected only while
    dtHeat > 10 dtMin (cpusolver.cpp:585-596). ``dt_heat`` is a number or a
    0-d float64 tensor."""
    dt_heat = scalar(dt_heat, storage.dtype, storage.device)
    sink = flow_sum * dt_heat
    mbe = (storage - storage_prev) - sink
    ref = torch.maximum(torch.abs(storage) * 1e-6, torch.abs(sink))
    mbr = mbe / torch.clamp_min(ref, 1.0)
    ok = (torch.abs(mbr) <= 1.0) | (dt_heat <= params.delta_t_min * 10.0)
    return sink, mbr, ok


def heat_step(grid: Grid, params: SolverParameters, heat: HeatState,
              boundary: HeatBoundary, water: WaterState,
              dt_heat, dt_water,
              conductances=None, evap_rate=None,
              heat_flow=None, energy_cache=None,
              flow_sum=None):
    """One heat sub-step of length ``dt_heat`` inside a water step of
    ``dt_water`` (CPUSolver::heatLoop, cpusolver.cpp:471-605); returns
    ``(new_state, mbr)`` with ``mbr`` read on the host (a float). The dts
    [s] are numbers or 0-d tensors.

    ``heat_flow`` is the chunk's frozen boundary flow [W] (recomputed from
    the current temperatures when omitted), ``energy_cache`` the hoisted
    :func:`energy_invariants` for this (dt_heat, dt_water) and
    ``flow_sum`` the masked sum of ``heat_flow``. With a float32
    ``sweep_dtype`` the assembly and sweeps run in float32 and the balance
    in float64. The coupled period's machine runs the same
    :func:`heat_system`, :func:`heat_sweep`, :func:`substep_end` and
    :func:`accept_substep` as its units."""
    if heat_flow is None:
        heat_flow, _, _ = boundary_heat(grid, params, heat, boundary, water, dt_heat,
                                        dt_water, conductances, evap_rate)
    with torch.profiler.record_function(HEAT_ASSEMBLE_RANGE):
        b_p, c_up, c_down, c_lat, heat_mask, t_cur, node_h64 = heat_system(
            grid, params, heat, water, dt_heat, dt_water, heat_flow, energy_cache)
    with torch.profiler.record_function(HEAT_SOLVE_RANGE):
        x, _ = heat_jacobi_solve(b_p, c_up, c_down, c_lat, heat_mask, t_cur,
                                 sweep_budget(params), heat_tolerance(params))
    if flow_sum is None:
        flow_sum = _masked_sum(heat_mask, heat_flow)
    t_new, storage, sink, mbr, ok = substep_end(
        grid, params, x, heat_mask, heat.t, heat.storage_prev, flow_sum, dt_heat,
        energy_cache, node_h64)
    t, storage_prev, sink_whole = accept_substep(ok, t_new, heat.t_old, storage,
                                                 heat.storage_prev, sink, heat.sink_whole)
    new_state = HeatState(t=t, t_old=t, sink_source=heat.sink_source,
                          storage_prev=storage_prev, storage_whole=heat.storage_whole,
                          sink_whole=sink_whole, mbr=mbr)
    return new_state, host_read(mbr)


def sweep_budget(params: SolverParameters) -> int:
    """The heat sweeps' budget: the reference's at the last approximation."""
    return params.max_iterations_for(params.max_approximations - 1)


def heat_tolerance(params: SolverParameters):
    """The heat sweeps' stop tolerance: max(tol, 1e-5) in float32 on the
    fast path, the residual tolerance on the float64 one."""
    if _is_fast(params):
        return max(np.float32(params.residual_tolerance), np.float32(1e-5))
    return params.residual_tolerance


def heat_system(grid: Grid, params: SolverParameters, heat: HeatState,
                water: WaterState, dt_heat, dt_water, heat_flow, energy_cache):
    """heat_step's assembly (per block on a mesh): the preconditioned
    system ``(b_p, c_up, c_down, c_lat, heat_mask)``, the sweeps' start
    ``t_cur`` and the interpolated float64 head."""
    return unzip(bmap(
        lambda g, hs, w, hf, ec: _heat_system(g, params, hs, w, dt_heat, dt_water, hf, ec),
        grid, blocks_of(heat), blocks_of(water), heat_flow, energy_cache))


def substep_end(grid: Grid, params: SolverParameters, x, heat_mask, t_field,
                storage_prev, flow_sum, dt_heat, inv=None, node_h64=None):
    """The end of a sub-step: the swept temperatures ``t_new`` on the heat
    nodes (``t_field`` elsewhere, in its dtype), their storage (from the
    invariants ``inv``, else from ``node_h64``) and the balance of
    :func:`substep_balance`: ``(t_new, storage, sink, mbr, ok)``."""
    t_new = bmap(lambda m, x, t: torch.where(m, x.to(t.dtype), t), heat_mask, x, t_field)
    if inv is not None:
        storage = _storage_from_invariants(grid, params, inv, t_new, heat_mask)
    else:
        storage = _masked_sum(heat_mask, bmap(
            lambda g, nh, t: _node_heat_energy(g, params, nh - g.z, t),
            grid, node_h64, t_new))
    return (t_new, storage) + substep_balance(storage, storage_prev, flow_sum, dt_heat,
                                              params)


def accept_substep(ok, t_new, t_keep, storage, storage_prev, sink, sink_whole):
    """A sub-step's selects: ``(t, storage_prev, sink_whole)``, the new
    ones where ``ok`` (a 0-d bool tensor), else ``t_keep`` and the old."""
    t = bmap(lambda a, b: torch.where(ok.to(a.device), a, b), t_new, t_keep)
    return (t, torch.where(ok, storage, storage_prev),
            torch.where(ok, sink_whole + sink, sink_whole))


def _heat_system(grid: Grid, params: SolverParameters, heat: HeatState,
                 water: WaterState, dt_heat, dt_water, heat_flow, energy_cache):
    """heat_step's assembly on one block (or the whole box): the
    preconditioned system ``(b_p, c_up, c_down, c_lat, heat_mask)``, the
    sweeps' start ``t_cur`` and the interpolated float64 head."""
    wf = params.heat_weight_factor
    fast = _is_fast(params)
    node_h64 = _node_h_from_timesteps(water, dt_heat, dt_water)
    if fast:
        sd = params.sweep_dtype
        g = grid.astype(sd)
        t_cur = heat.t.to(sd)
        t_prev = heat.t_old.to(sd)
        node_h = node_h64.to(sd)
        h_old_s = water.h_old.to(sd)
        avg_h = (0.5 * (water.h_old + node_h64) - grid.z).to(sd)
        hf = heat_flow.to(sd)
    else:
        g = grid
        t_cur, t_prev = heat.t, heat.t_old
        node_h, h_old_s = node_h64, water.h_old
        avg_h = 0.5 * (water.h_old + node_h64) - grid.z
        hf = heat_flow

    cached = fast and energy_cache is not None \
        and energy_cache.theta_avg is not None
    th_avg = energy_cache.theta_avg if cached else None
    cap = heat_capacity(g, params, avg_h, t_cur,
                        with_vapor=params.heat_vapor,
                        theta=th_avg) * g.volume
    # the air conductivity includes the latent vapor enhancement
    # whenever water is computed (heat.cpp:756-774)
    k_thermal = soil_thermal_conductivity(g, params, t_cur, avg_h,
                                          with_vapor=True, theta=th_avg)
    a_up, a_down, a_lat, heat_mask = _conduction_coeffs(
        g, params, heat, avg_h, k_thermal)

    # advected energy of the water-content change (cpusolver.cpp:500-518)
    if cached:
        theta_new, theta_old = energy_cache.theta_node, energy_cache.theta_old
    else:
        theta_new = theta_from_signed_psi(g, params, node_h - g.z)
        theta_old = theta_from_signed_psi(g, params, h_old_s - g.z)
    d_theta = theta_new - theta_old
    heat_cap_corr = d_theta * HEAT_CAPACITY_WATER * t_cur
    if params.heat_vapor:
        v_new = (_div(vapor_from_psi_temp(node_h - g.z, t_cur), WATER_DENSITY)
                 * torch.clamp_min(g.soil.theta_s - theta_new, 0.0))
        v_old = (_div(vapor_from_psi_temp(h_old_s - g.z, t_prev), WATER_DENSITY)
                 * torch.clamp_min(g.soil.theta_s - theta_old, 0.0))
        d_theta_v = v_new - v_old
        heat_cap_corr = (heat_cap_corr + d_theta_v * HEAT_CAPACITY_AIR * t_cur
                         + d_theta_v * latent_vaporization_heat(t_cur - ZEROCELSIUS)
                         * WATER_DENSITY)
    heat_cap_corr = heat_cap_corr * g.volume

    # inter-node advection: implicit upwind couplings, built in float64
    # and cast to the sweep dtype
    if params.heat_advection:
        adv = advective_link_coefficients(grid, params, heat, water,
                                          node_h64)
        adv_up, adv_down, adv_lat, adv_diag, adv_b = \
            (a.to(cap.dtype) for a in adv)
    else:
        adv_up = adv_down = torch.zeros_like(a_up)
        adv_lat = torch.zeros_like(a_lat)
        adv_diag = adv_b = torch.zeros_like(a_up)

    dth = scalar(dt_heat, cap.dtype, cap.device)
    sum_a = a_up + a_down + W._sum_lateral(a_lat)
    diag = sum_a * wf + adv_diag + cap / dth
    diag = torch.where(heat_mask, diag, 1.0)

    # explicit part: sum_j a_ij (1-wf) (T0_j - T0_i)
    t0 = t_prev
    f0 = (a_up * (torch.roll(t0, 1, dims=0) - t0)
          + a_down * (torch.roll(t0, -1, dims=0) - t0))
    for idx, (di, dj) in enumerate(LATERAL_OFFSETS):
        f0 = f0 + a_lat[idx] * (shift2d(t0, di, dj) - t0)
    f0 = f0 * (1.0 - wf)

    b = cap * t0 / dth - heat_cap_corr / dth + hf + f0 + adv_b
    if params.heat_vapor:
        # inter-node isothermal latent vapor fluxes enter the RHS as
        # invariant fluxes (computeHeatLinkFluxes, heat.cpp:432-446)
        b = b + isothermal_latent_link_flux(
            g, params, heat, water, node_h, t_field=t_cur, h_old=h_old_s,
            theta=energy_cache.theta_link if cached else None)
    b = torch.where(heat_mask, b, 0.0)

    inv_diag = torch.where(diag > 0, 1.0 / diag, 1.0)
    c_up = (a_up * wf + adv_up) * inv_diag
    c_down = (a_down * wf + adv_down) * inv_diag
    c_lat = (a_lat * wf + adv_lat) * inv_diag[None]
    b_p = b * inv_diag
    return b_p, c_up, c_down, c_lat, heat_mask, t_cur, node_h64


# ----------------------------------------------------------------------
# heat_frozen_props: per-chunk frozen system
# ----------------------------------------------------------------------

class FrozenChunkSystem(NamedTuple):
    """Per-chunk frozen heat system factors (params.heat_frozen_props):
    everything T-dependent evaluated once per boundary chunk at the
    chunk-start temperatures, stored without the 1/dt terms so every
    sub-step length folds its dt in with a few element-wise passes."""

    heat_mask: torch.Tensor
    aw_up: torch.Tensor         # implicit CN couplings a*wf (+advective)
    aw_down: torch.Tensor
    aw_lat: torch.Tensor
    ae_up: torch.Tensor         # explicit CN couplings a*(1-wf)
    ae_down: torch.Tensor
    ae_lat: torch.Tensor
    adiag: torch.Tensor         # sum_a*wf + adv_diag  (diag without cap/dt)
    cap: torch.Tensor           # heat capacity x volume [J K-1]
    const0: torch.Tensor        # hf + iso_latent + adv_b   [W]
    corr_rate: torch.Tensor     # advected-energy correction RATE [W]
    inv: SubstepInvariants
    flow_sum: torch.Tensor
    tol: np.float32


def chunk_frozen_system(grid: Grid, params: SolverParameters,
                        t_chunk: torch.Tensor, water: WaterState,
                        dt_heat, dt_water, heat_flow, flow_sum,
                        inv: SubstepInvariants) -> FrozenChunkSystem:
    """Assemble the frozen factors: heat_step's assembly with
    ``t_cur = t_prev = t_chunk`` and the chunk-dt interpolated head (on a
    mesh a Blocked of per-block systems, each holding the one
    ``flow_sum``)."""
    if not _is_fast(params):
        raise ValueError("heat_frozen_props requires the float32 fast path "
                         "(a float32 sweep_dtype)")
    return bmap(lambda g, t, w, hf, i: _frozen_system(
        g, params, t, w, dt_heat, dt_water, hf, flow_sum, i),
        grid, t_chunk, blocks_of(water), heat_flow, inv)


def _frozen_system(grid: Grid, params: SolverParameters,
                   t_chunk: torch.Tensor, water: WaterState,
                   dt_heat, dt_water, heat_flow, flow_sum,
                   inv: SubstepInvariants) -> FrozenChunkSystem:
    wf = params.heat_weight_factor
    sd = params.sweep_dtype
    node_h64 = _node_h_from_timesteps(water, dt_heat, dt_water)

    g = grid.astype(sd)
    t_cur = t_chunk.to(sd)
    node_h = node_h64.to(sd)
    h_old_s = water.h_old.to(sd)
    avg_h = (0.5 * (water.h_old + node_h64) - grid.z).to(sd)
    hf = heat_flow.to(sd)
    tol = heat_tolerance(params)

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

    if params.heat_advection:
        adv = advective_link_coefficients(grid, params, heat_pseudo, water,
                                          node_h64)
        adv_up, adv_down, adv_lat, adv_diag, adv_b = \
            (a.to(cap.dtype) for a in adv)
    else:
        adv_up = adv_down = torch.zeros_like(a_up)
        adv_lat = torch.zeros_like(a_lat)
        adv_diag = adv_b = torch.zeros_like(a_up)

    sum_a = a_up + a_down + W._sum_lateral(a_lat)

    const0 = hf + adv_b
    if params.heat_vapor:
        const0 = const0 + isothermal_latent_link_flux(
            g, params, heat_pseudo, water, node_h,
            t_field=t_cur, h_old=h_old_s, theta=inv.theta_link)

    return FrozenChunkSystem(
        heat_mask=heat_mask,
        aw_up=a_up * wf + adv_up,
        aw_down=a_down * wf + adv_down,
        aw_lat=a_lat * wf + adv_lat,
        ae_up=a_up * (1.0 - wf),
        ae_down=a_down * (1.0 - wf),
        ae_lat=a_lat * (1.0 - wf),
        adiag=sum_a * wf + adv_diag,
        cap=cap, const0=const0,
        corr_rate=heat_cap_corr / scalar(dt_heat, cap.dtype, cap.device),
        inv=inv, flow_sum=flow_sum, tol=tol)


def heat_substep_frozen(grid: Grid, params: SolverParameters,
                        fz: FrozenChunkSystem, t_field: torch.Tensor,
                        storage_prev, sink_whole, dt_heat):
    """One sub-step over a frozen chunk system: fold the sub-step dt in,
    the RHS from the current T, Jacobi sweeps, the float64 balance and the
    accept decision. Returns ``(t, storage_prev, sink_whole, mbr, ok)``
    with ``ok`` read on the host (a bool). ``dt_heat`` [s] is a number or a
    0-d tensor. The coupled period's machine runs the same
    :func:`fold_dt`, :func:`heat_sweep`, :func:`substep_end` and
    :func:`accept_substep` as its units."""
    fz0 = first_block(fz)
    mask = bmap(lambda f: f.heat_mask, fz)
    with torch.profiler.record_function(HEAT_ASSEMBLE_RANGE):
        b_p, c_up, c_down, c_lat, t0 = fold_dt(params, fz, t_field, dt_heat)
    with torch.profiler.record_function(HEAT_SOLVE_RANGE):
        x, _ = heat_jacobi_solve(b_p, c_up, c_down, c_lat, mask, t0,
                                 sweep_budget(params), fz0.tol)
    t_new, storage, sink, mbr, ok = substep_end(
        grid, params, x, mask, t_field, storage_prev, fz0.flow_sum, dt_heat,
        bmap(lambda f: f.inv, fz))
    t, storage_prev, sink_whole = accept_substep(ok, t_new, t_field, storage,
                                                 storage_prev, sink, sink_whole)
    return t, storage_prev, sink_whole, mbr, bool(host_read(ok))


def fold_dt(params: SolverParameters, fz, t_field, dt_heat):
    """A sub-step's preconditioned system ``(b_p, c_up, c_down, c_lat)`` of
    length ``dt_heat`` over a frozen chunk system (per block on a mesh),
    and the sweeps' start."""
    return unzip(bmap(lambda f, t: _fold_dt(params, f, t, dt_heat), fz, t_field))


def _fold_dt(params: SolverParameters, fz: FrozenChunkSystem, t_field, dt_heat):
    """One block's preconditioned system ``(b_p, c_up, c_down, c_lat)`` of
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
    """Total heat storage [J] (computeCurrentHeatStorage, heat.cpp:344-357);
    on a mesh a sum of the blocks' owned-cell partials."""
    return _masked_sum(bmap(_heat_mask, grid), bmap(
        lambda g, h, t: _node_heat_energy(g, params, h - g.z, t),
        grid, water.h, heat.t))

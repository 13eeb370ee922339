"""Crop development, root water uptake, and the ET sink assembly.

PyTorch counterpart of ``criteria3d_tpu/physics/crop.py``: degree-day
phenology and the LAI curve (crop.cpp:161-234, development.cpp:42-155),
root growth and density (root.cpp:139-170, 255-363, 505-600), the per-cell
sink assembly (Project3D::assignEvaporation / assignTranspiration,
project3D.cpp:2287-2608) and the slope factor of safety
(project3D.cpp:2618-2720), as whole-map tensor passes with the same
expressions and order as the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from criteria3d_tpu_torch.constants import DEG_TO_RAD, EPSILON, GRAVITY
from criteria3d_tpu_torch.core.grid import Grid
from criteria3d_tpu_torch.core.soil import power, se_from_psi, theta_from_se
from criteria3d_tpu_torch.core.state import SolverParameters
from criteria3d_tpu_torch.ops import as_f64, div, rdiv, where

__all__ = ["CropParameters", "degree_day_increase", "lai_from_degree_days",
           "covered_surface_fraction", "potential_evaporation",
           "potential_transpiration", "root_length", "root_density_atoms",
           "root_density_profile", "transpiration_sink", "evaporation_sink",
           "evaporation_layer_coefficients", "factor_of_safety",
           "water_content_thresholds", "SINKS_RANGE"]

# torch.profiler range of the sink assembly: interception, cracking,
# evaporation and transpiration (chip_smoke.py reads it)
SINKS_RANGE = "c3d.sinks"

# standard matric potentials (soil.cpp:522-583) [kPa]
PSI_WILTING_POINT_KPA = -1600.0
PSI_HYGROSCOPIC_KPA = -3000.0
MAX_EVAPORATION_DEPTH = 0.25     # [m] (project3D.h)


@dataclasses.dataclass(frozen=True)
class CropParameters:
    """Subset of Crit3DCrop (crop.h:20-112) needed for LAI + uptake."""

    lai_min: float = 0.2
    lai_max: float = 4.0
    lai_curve_a: float = 5.0      # [-] logistic shape a
    lai_curve_b: float = -0.01    # [DD-1] logistic shape b (negative)
    thermal_threshold: float = 0.0       # [degC]
    upper_thermal_threshold: float = 30.0
    degree_days_increase: float = 1200.0  # [DD] end of LAI growth
    degree_days_decrease: float = 2000.0  # [DD] length of decrease phase
    degree_days_emergence: float = 80.0
    kc_max: float = 1.2
    f_raw: float = 0.55           # readily-available-water fraction
    is_tree: bool = False
    water_surplus_resistant: bool = False
    # roots
    root_depth_min: float = 0.05  # [m]
    root_depth_max: float = 0.8   # [m]
    degree_days_root_growth: float = 1000.0
    root_shape_deformation: float = 1.0   # [1..2]


def degree_day_increase(crop: CropParameters, t_min, t_max):
    """Daily thermal time increment [DD] (crop.cpp:161-174)."""
    t_med = 0.5 * (t_min + torch.clamp_max(t_max, crop.upper_thermal_threshold))
    return torch.clamp_min(t_med - crop.thermal_threshold, 0.0)


def lai_from_degree_days(crop: CropParameters, degree_days):
    """LAI from thermal time (getLAICriteria, development.cpp:132-155)."""
    c4 = 15.0 if crop.is_tree else 9.0
    n4 = 4.0      # a float: a real pow, as in the JAX function
    dd = as_f64(degree_days)
    growing = crop.lai_min + rdiv(crop.lai_max - crop.lai_min,
                                  1.0 + torch.exp(crop.lai_curve_a
                                                  + crop.lai_curve_b * dd))
    decl_x = div(10.0 * div(dd - crop.degree_days_increase,
                            max(crop.degree_days_decrease, 1.0)), c4)
    declining = crop.lai_min + rdiv(crop.lai_max - crop.lai_min,
                                    1.0 + power(torch.clamp_min(decl_x, 0.0), n4))
    return torch.where(dd <= crop.degree_days_increase, growing, declining)


def covered_surface_fraction(lai):
    """1 - exp(-k LAI), k = 0.6 (project3D.cpp:2295-2301)."""
    return where(lai < EPSILON, 0.0, 1.0 - torch.exp(-0.6 * lai))


def potential_evaporation(et0, lai):
    """[mm] (project3D.cpp:2309-2314)."""
    return et0 * (1.0 - covered_surface_fraction(lai))


def potential_transpiration(et0, lai, kc_max):
    """[mm] (project3D.cpp:2323-2328)."""
    f = covered_surface_fraction(lai)
    return et0 * f * (1.0 + (kc_max - 1.0) * f)


def root_length(crop: CropParameters, degree_days, soil_depth):
    """Current root length [m] (computeRootLength3D + getRootLengthDD,
    crop.cpp:651-690, root.cpp:139-170; linear growth)."""
    actual_max = min(crop.root_depth_max, soil_depth)
    max_len = actual_max - crop.root_depth_min
    dd = as_f64(degree_days)
    frac = torch.clamp(div(dd, crop.degree_days_root_growth), 0.0, 1.0)
    length = where(dd <= 1.0, 0.0, max_len * frac)
    return torch.clamp_min(length, 0.0)


def _cardioid_cdf(t):
    """Fraction of (undeformed) double-lunette root mass above the
    normalised rooted depth t in [0, 1] (continuous limit of
    cardioidDistribution, root.cpp:255-318)."""
    def g(s):
        u = torch.clamp(1.0 - s, -1.0, 1.0)
        return div(math.pi / 2.0 - torch.arcsin(u) - u * torch.sqrt(
            torch.clamp_min(1.0 - u * u, 0.0)), math.pi)

    t = torch.clamp(t, 0.0, 1.0)
    first = g(2.0 * t)
    second = 1.0 - g(2.0 * (1.0 - t))
    return torch.where(t <= 0.5, first, second)


def _atom_layer_onehot(grid: Grid, n_atoms: int) -> np.ndarray:
    """Static atom -> layer one-hot (first matching layer wins; atoms past
    the deepest layer dropped -- root.cpp:566-586), built on the host."""
    depths = np.asarray(grid.layer_depth)
    thicks = np.asarray(grid.layer_thickness)
    uppers, lowers = depths - 0.5 * thicks, depths + 0.5 * thicks
    max_depth = float(lowers[-1])
    onehot = np.zeros((grid.n_layers, n_atoms))
    for a in range(n_atoms):
        z = a * 0.01
        if z > max_depth:
            break
        for l in range(grid.n_layers):
            if uppers[l] <= z <= lowers[l]:
                onehot[l, a] = 1.0
                break
    return onehot


def root_density_atoms(crop: CropParameters, grid: Grid, length,
                       shape: str = "cardioid"):
    """Per-layer root density (L, R, C) by the reference's 1-cm atom scheme
    (root::computeRootDensity3D, root.cpp:504-613): per-cell rooted-atom
    counts as closed-form functions of the atom index, the atom-to-layer
    binning as a contraction with a host-built one-hot, and both
    distribution kernels (cardioidDistribution root.cpp:255-318,
    cylindricalDistribution root.cpp:321-364, with its second-half-only
    normalisation, which the final renormalisation hides). Normalised to 1
    over the simulated subset. The atom intermediates are
    (n_atoms, R, C) float64."""
    depths = np.asarray(grid.layer_depth)
    thicks = np.asarray(grid.layer_thickness)
    soil_depth = float(depths[-1] + 0.5 * thicks[-1])
    n_atoms = int(soil_depth * 100) + 1
    n_unrooted = int(round(crop.root_depth_min / 0.01))
    dev = grid.device

    length = as_f64(length, dev)
    n = torch.round(div(torch.clamp_max(length, soil_depth), 0.01)).to(torch.int32)
    n = torch.clamp_max(n, n_atoms - n_unrooted)
    nf = torch.clamp_min(n, 1).to(torch.float64)

    a_idx = torch.arange(n_atoms, dtype=torch.int32, device=dev)[:, None, None]
    i = (a_idx - n_unrooted).to(torch.float64)          # rooted atom index
    rooted = (a_idx >= n_unrooted) & (i < nf) & (n > 0)

    deform = min(max(crop.root_shape_deformation, 1.0), 2.0)
    if shape == "cardioid":
        def lun(idx):
            # lunette area function (root.cpp:277-284)
            s = 1.0 - (idx + 1.0) / nf
            c = torch.clamp_min(torch.sqrt(torch.clamp_min(1.0 - s * s, 0.0)), 1e-4)
            alfa = torch.atan2(s, c)
            return div(math.pi / 2.0 - alfa - s * c, math.pi)

        def halfdens(j):
            jc = torch.minimum(torch.clamp_min(j, 0.0), nf - 1.0)
            return torch.where(j <= 0.0, lun(torch.zeros_like(jc)),
                               lun(jc) - lun(jc - 1.0))

        def slot(s):
            # mirrored double lunette over 2n slots (root.cpp:286-293)
            return torch.where(s < nf, halfdens(s),
                               halfdens(2.0 * nf - s - 1.0))

        log02 = torch.log(torch.tensor(0.2, dtype=torch.float64, device=dev))
        log005 = torch.log(torch.tensor(0.05, dtype=torch.float64, device=dev))
        li_min = -log02 / nf
        li_max = -log005 / nf
        k = li_min + (li_max - li_min) * (deform - 1.0)
        s1, s2 = 2.0 * i, 2.0 * i + 1.0
        w1 = slot(s1) * torch.exp(-k * (s1 + 0.5))
        w2 = slot(s2) * torch.exp(-k * (s2 + 0.5))
        w = where(rooted, w1 + w2, 0.0)
    elif shape == "cylindrical":
        # base 1/(2n) with linear deformation ramped per slot
        # (root.cpp:329-351: deformation decremented BEFORE multiplying in
        # the second half, and only the second half is divided by the
        # running sum -- replicated, the final renormalisation absorbs it)
        dd = deform - 1.0
        s1, s2 = 2.0 * i, 2.0 * i + 1.0

        def cyl(s):
            base = rdiv(1.0, 2.0 * nf)
            d_at = torch.where(s < nf, deform - dd * s / nf,
                               deform - dd * (s + 1.0) / nf)
            return base * d_at

        w = where(rooted, cyl(s1) + cyl(s2), 0.0)
    else:
        raise ValueError(f"unknown root shape: {shape}")
    norm = torch.sum(w, dim=0, keepdim=True)
    atom_density = where(norm > 0, w / torch.clamp_min(norm, 1e-300), 0.0)

    hot = torch.tensor(_atom_layer_onehot(grid, n_atoms), dtype=torch.float64,
                       device=dev)
    dens = torch.tensordot(hot, atom_density, dims=1)
    dens = where(grid.mask, dens, 0.0)
    total = torch.sum(dens, dim=0, keepdim=True)
    return where(total > EPSILON, dens / torch.clamp_min(total, 1e-12), 0.0)


def root_density_profile(crop: CropParameters, grid: Grid, length,
                         method: str = "atoms", n_quad: int = 256):
    """Per-layer root density fractions (L, R, C), summing to 1 where
    rooted: ``method="atoms"`` (default) is the reference's 1-cm atom
    scheme (:func:`root_density_atoms`), ``method="quadrature"`` the smooth
    continuous-limit evaluation."""
    if method == "atoms":
        return root_density_atoms(crop, grid, length)
    return _root_density_quadrature(crop, grid, length, n_quad)


def _root_density_quadrature(crop: CropParameters, grid: Grid, length,
                             n_quad: int = 256):
    """Per-layer root density fractions (L, R, C) of the deformed-cardioid
    profile (root.cpp:255-318) by quadrature over the rooted depth."""
    L = grid.n_layers
    dev = grid.device
    length = torch.clamp_min(as_f64(length, dev), 1e-9)
    top = crop.root_depth_min

    shape = min(max(crop.root_shape_deformation, 1.0), 2.0)
    li_min = -np.log(0.2)
    li_max = -np.log(0.05)
    li = float(2.0 * (li_min + (li_max - li_min) * (shape - 1.0)))

    # quadrature nodes over normalised rooted depth
    t = div(torch.arange(n_quad, dtype=torch.float64, device=dev) + 0.5, n_quad)
    pdf = torch.diff(_cardioid_cdf(div(torch.arange(
        n_quad + 1, dtype=torch.float64, device=dev), n_quad)))
    w = pdf * torch.exp(-li * t)
    w = w / torch.sum(w)                      # (n_quad,)

    depths = np.asarray(grid.layer_depth)
    thicks = np.asarray(grid.layer_thickness)
    uppers = depths - thicks * 0.5
    lowers = depths + thicks * 0.5

    out = []
    zq = top + t[:, None, None] * length[None]          # (n_quad, R, C)
    for l in range(L):
        if l == 0:
            out.append(torch.zeros_like(length))
            continue
        inside = (zq >= float(uppers[l])) & (zq < float(lowers[l]))
        out.append(torch.sum(torch.where(inside, w[:, None, None], 0.0), dim=0))
    dens = torch.stack(out)
    dens = where(grid.mask, dens, 0.0)
    # renormalise over the simulated subset (root.cpp:591-600)
    total = torch.sum(dens, dim=0, keepdim=True)
    return where(total > EPSILON, dens / torch.clamp_min(total, 1e-12), 0.0)


def water_content_thresholds(grid: Grid, params: SolverParameters,
                             clay_pct: float = 25.0):
    """(theta_sat, theta_fc, theta_wp, theta_hh) maps from the VG curves;
    FC potential is clay-dependent -10..-33 kPa (getFieldCapacity,
    soil.cpp:522-553); WP = -1600 kPa, HH = -3000 kPa."""
    if clay_pct <= 20:
        fc_kpa = -10.0
    elif clay_pct >= 50:
        fc_kpa = -33.0
    else:
        fc_kpa = -10.0 + (-33.0 + 10.0) * (clay_pct - 20.0) / 30.0

    def theta_at(kpa):
        psi_m = abs(kpa) / GRAVITY   # [kPa] -> [m]
        se = se_from_psi(grid.soil, torch.full_like(grid.soil.theta_s, psi_m),
                         params.wrc_model)
        return theta_from_se(grid.soil, se)

    return (grid.soil.theta_s, theta_at(fc_kpa),
            theta_at(PSI_WILTING_POINT_KPA), theta_at(PSI_HYGROSCOPIC_KPA))


def transpiration_sink(grid: Grid, params: SolverParameters, crop: CropParameters,
                       theta, et0, lai, degree_days, soil_depth=None,
                       demand_mm=None):
    """Actual transpiration sink: (sink [m3 s-1] (L,R,C), actual [mm] (R,C))
    (assignTranspiration, project3D.cpp:2461-2608): per-layer water-stress
    ratios against the scarcity/surplus thresholds, hydraulic
    redistribution from unstressed roots. ``demand_mm`` optionally caps the
    potential transpiration with an external stomatal demand."""
    if soil_depth is None:
        soil_depth = float(grid.layer_depth[-1] + grid.layer_thickness[-1] * 0.5)

    max_t = potential_transpiration(et0, lai, crop.kc_max)     # (R,C) [mm]
    if demand_mm is not None:
        max_t = torch.minimum(max_t, as_f64(demand_mm, max_t.device))
    length = root_length(crop, degree_days, soil_depth)
    density = root_density_profile(crop, grid, length)          # (L,R,C)

    theta_sat, theta_fc, theta_wp, _ = water_content_thresholds(grid, params)
    surplus_frac = 0.0 if crop.water_surplus_resistant else 0.5
    thr_surplus = theta_sat - surplus_frac * (theta_sat - theta_fc)
    thr_scarcity = theta_fc - crop.f_raw * (theta_fc - theta_wp)

    ratio_scarce = (theta - theta_wp) / torch.clamp_min(thr_scarcity - theta_wp, 1e-9)
    ratio_surplus = (theta_sat - theta) / torch.clamp_min(theta_sat - thr_surplus, 1e-9)
    ratio = where(theta <= theta_wp, 0.0,
                  torch.where(theta < thr_scarcity, ratio_scarce,
                              where(theta - thr_surplus > EPSILON,
                                    ratio_surplus, 1.0)))
    stressed = (theta <= theta_wp) | (theta < thr_scarcity) \
        | (theta - thr_surplus > EPSILON)

    rooted = density > 0
    layer_t = max_t[None] * density * ratio                     # [mm] (L,R,C)
    subset_max = torch.sum(max_t[None] * density, dim=0)        # [mm] (R,C)
    actual = torch.sum(layer_t, dim=0)

    # hydraulic redistribution (project3D.cpp:2578-2592)
    unstressed_density = torch.sum(where(rooted & ~stressed, density, 0.0), dim=0)
    stress = 1.0 - actual / torch.clamp_min(subset_max, 1e-12)
    apply = (stress > EPSILON) & (unstressed_density > EPSILON) & (subset_max > 0)
    redistribution = subset_max * torch.minimum(stress, unstressed_density)
    add = redistribution[None] * density / torch.clamp_min(unstressed_density, 1e-12)
    layer_t = torch.where(apply[None] & ~stressed & (layer_t > 0),
                          layer_t + add, layer_t)

    valid = (lai >= EPSILON)[None] & grid.mask
    layer_t = where(valid, layer_t, 0.0)
    sink = div(-grid.area * div(layer_t, 1000.0), 3600.0)        # [m3 s-1]
    return sink, torch.sum(layer_t, dim=0)


def evaporation_layer_coefficients(grid: Grid):
    """Normalised per-layer soil evaporation weights
    (initializeEvaporationCoefficient, project3D.cpp:2331-2370): numpy
    ``(coeff, layer_coeff, last_layer)``."""
    depths = np.asarray(grid.layer_depth)
    thicks = np.asarray(grid.layer_thickness)
    L = grid.n_layers
    last = 1
    for l in range(1, L):
        if depths[l] <= MAX_EVAPORATION_DEPTH:
            last = l
    coeff = np.zeros(L)
    layer_coeff = np.zeros(L)
    for l in range(1, last + 1):
        d = max((depths[l] - depths[1]) / (MAX_EVAPORATION_DEPTH - depths[1]), 0.0)
        coeff[l] = np.exp(-2.0 * d)
        layer_coeff[l] = coeff[l] * (thicks[l] / 0.04)
    s = layer_coeff.sum()
    if s > 0:
        layer_coeff /= s
    return coeff, layer_coeff, last


def evaporation_sink(grid: Grid, params: SolverParameters, theta, surface_water,
                     et0, lai):
    """Surface + shallow-soil evaporation sink (assignEvaporation,
    project3D.cpp:2377-2451): surface water evaporates first; the residual
    demand is spread over the top soil layers with exponentially decreasing
    coefficients in up to 3 passes. Returns (sink [m3 s-1] (L,R,C),
    actual [mm] (R,C))."""
    dev = grid.device
    max_evap = potential_evaporation(et0, lai)                  # [mm]
    evap_coeff, layer_coeff, last = evaporation_layer_coefficients(grid)

    def column(a):
        return torch.tensor(a, dtype=torch.float64, device=dev).reshape(-1, 1, 1)

    surf_mm = surface_water * 1000.0
    surf_evap = torch.minimum(max_evap, surf_mm)
    surf_flow = div(grid.area * div(surf_evap, 1000.0), 3600.0)
    surf_evap = where(surf_flow <= 2.3e-16, 0.0, surf_evap)

    _, theta_fc, _, theta_hh = water_content_thresholds(grid, params)
    thr = theta_hh + (1.0 - column(evap_coeff)) * (theta_fc - theta_hh) * 0.5

    thick = column(np.asarray(grid.layer_thickness))
    layer_idx = torch.arange(grid.n_layers, device=dev).reshape(-1, 1, 1)
    evap_layer_ok = (layer_idx >= 1) & (layer_idx <= last) & grid.mask

    residual = torch.clamp_min(max_evap - surf_evap, 0.0)
    layer_evap_total = torch.zeros_like(theta)
    avail = where(evap_layer_ok,
                  torch.clamp_min(theta - thr, 0.0) * thick * 1000.0, 0.0)
    lc = column(layer_coeff)
    for _ in range(3):
        demand = residual[None] * lc
        take = torch.minimum(avail - layer_evap_total, demand)
        take = where(take > EPSILON, take, 0.0)
        layer_evap_total = layer_evap_total + take
        residual = torch.clamp_min(residual - torch.sum(take, dim=0), 0.0)

    actual = surf_evap + torch.sum(layer_evap_total, dim=0)
    sink = div(-grid.area * div(layer_evap_total, 1000.0), 3600.0)
    sink[0] += div(-grid.area * div(surf_evap, 1000.0), 3600.0)
    sink = where(grid.mask, sink, 0.0)
    return sink, actual


def factor_of_safety(grid: Grid, params: SolverParameters, h, se,
                     slope_deg, *, effective_cohesion=5.0, friction_angle=30.0,
                     bulk_density=1.4, increase_slope=False):
    """Infinite-slope factor of safety with suction stress, per layer
    (computeFactorOfSafety, project3D.cpp:2618-2720). Returns an (L, R, C)
    map (layer 0 = NaN). FoS < 1 => unstable."""
    slope = as_f64(slope_deg, grid.device)
    if increase_slope:
        slope = torch.clamp_max(slope * 1.5, 89.0)
    slope_rad = torch.clamp_min(slope * DEG_TO_RAD, EPSILON)
    tan_angle = torch.clamp_min(torch.tan(slope_rad), EPSILON)
    tan_friction = float(np.tan(np.radians(friction_angle)))
    friction_effect = rdiv(tan_friction, tan_angle)

    # suction stress [kPa] = matric potential [kPa] * Se
    psi_kpa = torch.clamp_max((h - grid.z) * GRAVITY, 0.0)
    suction_stress = psi_kpa * se

    # water content per node
    theta = theta_from_se(grid.soil, se)

    # cumulative overburden weight from the surface down [kPa]
    surf_water = torch.clamp_min(h[0] - grid.z[0], 0.0)
    thick = torch.tensor(np.asarray(grid.layer_thickness), dtype=torch.float64,
                         device=grid.device).reshape(-1, 1, 1)
    unit_weight = (bulk_density + theta) * GRAVITY * thick      # [kPa] per layer
    unit_weight[0] = surf_water * GRAVITY
    weight_cum = torch.cumsum(where(grid.mask, unit_weight, 0.0), dim=0)
    weight_cum = torch.clamp_min(weight_cum, 1e-6)

    cohesion_effect = rdiv(2.0 * effective_cohesion,
                           weight_cum * torch.sin(2.0 * slope_rad)[None])
    suction_effect = (suction_stress * (tan_angle + rdiv(1.0, tan_angle))[None]
                      * tan_friction) / weight_cum

    fos = friction_effect[None] + cohesion_effect - suction_effect
    fos = where(grid.mask, fos, math.nan)
    fos[0] = math.nan
    return fos

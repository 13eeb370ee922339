"""HYDRALL forest carbon and water model (Magnani, UNIBO), whole-map.

PyTorch counterpart of ``criteria3d_tpu/physics/hydrall.py``
(src/hydrall/hydrall.cpp): sun/shade big-leaf radiation absorption
(radiationAbsorption, hydrall.cpp:712-841), leaf temperature
(leafTemperature, :863-884), Farquhar parameter upscaling with
Kattge-Knorr acclimation (upscale, :1153-1247), the coupled assimilation /
stomatal conductance / transpiration fixed point (photosynthesisKernel,
:1306-1394), plant respiration (:1542-1600) and the simplified annual
allocation (simplifiedGrowthStand, :1694-1800), then the hourly, daily and
annual map drivers of Crit3DProject (criteria3DProject.cpp:634-700,
1827-1915). Every map is float64.

The fixed point has a per-cell stop, as JAX's ``lax.while_loop``: a cell
freezes at its own stopping iterate, and the loop ends when every cell is
done or at ``max_iter``. It is a state machine on the device
(physics/fixed_point.py): CUDA graphs on the card, one host read a call;
``CHECK_EVERY`` iterations a unit and a host read after each on the CPU.
The kernel returns each cell's stop iteration;
``photosynthesis_kernel.iterations`` counts the loop iterations JAX would
run (reset it to 0 before a run).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from criteria3d_tpu_torch.constants import (R_GAS, STEFAN_BOLTZMANN,
                                            ZEROCELSIUS)
from criteria3d_tpu_torch.core.soil import power
from criteria3d_tpu_torch.device import map_tensors, resolve_device
from criteria3d_tpu_torch.ops import as_f64, div, ipow, rdiv, sq, where
from criteria3d_tpu_torch.physics import fixed_point
from criteria3d_tpu_torch.physics.fixed_point import CHECK_EVERY

__all__ = ["HydrallPlantState", "HydrallMaps", "big_leaf_radiation",
           "leaf_temperature", "farquhar_parameters", "photosynthesis_kernel",
           "plant_respiration", "annual_growth", "atmospheric_co2_ppm",
           "hydrall_hour", "hydrall_daily_update", "hydrall_annual_update",
           "HYDRALL_RANGE", "CHECK_EVERY"]

# torch.profiler range of the HYDRALL hour (chip_smoke.py reads it)
HYDRALL_RANGE = "c3d.hydrall"

# hydrall.h:43-57: Farquhar/Arrhenius parameters [kJ mol-1] and scale factors
HARD, HAVCM, HAJM = 46.39, 65.33, 43.9
HAKC, HAKO, HAGSTAR = 79.43, 36.38, 37.83
HDEACTIVATION = 200.0
CRD, CVCM, CGSTAR, CKC, CKO, CJM = 18.72, 26.35, 19.02, 38.05, 20.30, 17.7
RESPIRATION_PARAMETER = 1.47222e-6      # hydrall.h:33
OSS = 21176.0                           # O2 partial pressure [Pa]
HEAT_CAPACITY_AIR_MOLAR = 29.31
CARBON_FACTOR = 0.5                     # kg C per kg DM


def _f64(x, like: torch.Tensor) -> torch.Tensor:
    return as_f64(x, like.device)


def upscaling_func(k, lai):
    """(1 - exp(-k LAI)) / k (hydrall.h:14)."""
    k = torch.clamp_min(k, 1e-9)
    return (1.0 - torch.exp(-k * lai)) / k


@dataclasses.dataclass(frozen=True, eq=False)
class HydrallPlantState:
    """Tree carbon pools [kg DM m-2] + the annual NPP accumulator."""

    biomass_foliage: torch.Tensor
    biomass_sapwood: torch.Tensor
    biomass_root: torch.Tensor
    npp_year: torch.Tensor      # [kg C m-2] net primary production, running

    @staticmethod
    def initialize(shape=(), foliage=0.2, sapwood=6.0, root=0.4,
                   dtype=torch.float64, device=None) -> "HydrallPlantState":
        """``device=None`` means the CUDA card."""
        dev = resolve_device(device)

        def f(v):
            return torch.full(tuple(shape), v, dtype=dtype, device=dev)

        return HydrallPlantState(biomass_foliage=f(foliage),
                                 biomass_sapwood=f(sapwood),
                                 biomass_root=f(root), npp_year=f(0.0))


def _leaf_absorbance_par(chlorophyll: float, device) -> torch.Tensor:
    """1 - 10^-(10^(0.28 + 0.63 log10(chl 0.85 / 1000))) (Agusti et al.
    1994), as a 0-d float64 tensor: log10 as log(x) times 1 / log(10), as
    jnp.log10 computes it."""
    c = torch.tensor(chlorophyll * 0.85 / 1000.0, dtype=torch.float64,
                     device=device)
    ten = torch.tensor(10.0, dtype=torch.float64, device=device)
    log10 = torch.log(c) * 0.4342944819032518
    exponent = -power(ten, 0.28 + 0.63 * log10)
    return 1.0 - power(ten, exponent)


def big_leaf_radiation(lai, sine_solar_elevation, direct_irradiance,
                       diffuse_irradiance, air_temp_c, longwave_irradiance,
                       *, chlorophyll=500.0, clumping=1.0):
    """Sun/shade absorbed PAR [mol m-2 s-1] and isothermal net radiation
    (radiationAbsorption, hydrall.cpp:712-841): a dict with the sunlit /
    shaded LAI, absorbed PAR and net radiation, and the extinction
    coefficients :func:`farquhar_parameters` takes. Numbers are taken as
    float64 tensors on the CPU."""
    sin_b = torch.clamp_min(as_f64(sine_solar_elevation), 1e-6)
    lai = torch.clamp_min(_f64(lai, sin_b), 1e-6)
    dev = lai.device

    kb = torch.clamp_max(rdiv(0.5, sin_b), 50.0) * clumping
    e = torch.exp(-0.5 * lai)
    kd = rdiv(-1.0, lai) * torch.log(0.178 * e + 0.514 * e + 0.308 * e) \
        * clumping

    absorb_par = _leaf_absorbance_par(chlorophyll, dev)
    scat_par = 1.0 - absorb_par
    scat_nir = torch.tensor(0.8, dtype=torch.float64, device=dev)

    sq_par = torch.sqrt(1 - scat_par)
    sq_nir = torch.sqrt(1 - scat_nir)
    kd_par = kd * sq_par
    kd_nir = kd * sq_nir
    kb_par = kb * sq_par
    kb_nir = kb * sq_nir

    rho_h_par = (1 - sq_par) / (1 + sq_par)
    rho_h_nir = (1 - sq_nir) / (1 + sq_nir)
    beam_frac = 2.0 * kb / (kb + kd)
    rho_b_par = beam_frac * rho_h_par
    rho_b_nir = beam_frac * rho_h_nir

    i_dir = _f64(direct_irradiance, lai) * 0.5       # PAR = NIR = 0.5 I
    i_dif = _f64(diffuse_irradiance, lai) * 0.5

    day = sin_b > 1e-3
    lai_sun = where(day, upscaling_func(kb, lai), 0.0)
    lai_shade = lai - lai_sun

    d5 = i_dif * (1 - rho_h_par) * kd_par
    d6 = i_dir * (1 - rho_b_par) * kb_par
    d7 = i_dir * (1 - scat_par) * kb
    d8 = i_dif * (1 - rho_h_nir) * kd_nir
    d9 = i_dir * (1 - rho_b_nir) * kb_nir
    d10 = i_dir * (1 - scat_nir) * kb
    d11 = upscaling_func(kd_par + kb, lai)
    d12 = upscaling_func(kb_par + kb, lai)
    d13 = d11
    d14 = upscaling_func(kb_nir + kb, lai)
    d15 = upscaling_func(kb, lai) - upscaling_func(2.0 * kb, lai)
    d16 = (_f64(longwave_irradiance, lai)
           - STEFAN_BOLTZMANN * ipow(_f64(air_temp_c, lai) + ZEROCELSIUS, 4)) * kd

    par_sun = d5 * d11 + d6 * d12 + d7 * d15
    par_shade = (d5 * (upscaling_func(kd_par, lai) - d11)
                 + d6 * (upscaling_func(kb_par, lai) - d12) - d7 * d15)
    nir_sun = d8 * d13 + d9 * d14 + d10 * d15
    nir_shade = (d8 * (upscaling_func(kd_nir, lai) - d13)
                 + d9 * (upscaling_func(kb_nir, lai) - d14) - d10 * d15)

    em_leaf = 0.96
    lw_sun = d16 * upscaling_func(kb + kd, lai) * em_leaf
    lw_shade = d16 * upscaling_func(kd, lai) - lw_sun

    rni_sun = where(day, par_sun + nir_sun + lw_sun, 0.0)
    rni_shade = par_shade * day + nir_shade * day + lw_shade

    return dict(
        lai_sunlit=lai_sun, lai_shaded=lai_shade,
        par_sunlit=where(day, par_sun, 0.0) * 4.57e-6,
        par_shaded=where(day, par_shade, 0.0) * 4.57e-6,
        rni_sunlit=rni_sun, rni_shaded=rni_shade,
        kb=kb, kd=kd, kd_par=kd_par)


def leaf_temperature(air_temp_c, direct_irradiance, diffuse_irradiance,
                     vpd_pa, psychro_pa, sine_solar_elevation):
    """(T_sunlit, T_shaded) [K], Stanghellini 1987 (hydrall.cpp:863-884)."""
    sin_el = as_f64(sine_solar_elevation)
    day = sin_el > 1e-3
    diffuse = _f64(diffuse_irradiance, sin_el)
    shaded_rad = diffuse * 3600.0
    sunlit_rad = (diffuse + _f64(direct_irradiance, sin_el)) * 3600.0
    corr = -0.25 * _f64(vpd_pa, sin_el) / _f64(psychro_pa, sin_el)
    air = _f64(air_temp_c, sin_el)
    t_shade = torch.where(day, air + 1.67e-6 * shaded_rad + corr, air)
    t_sun = torch.where(day, air + 1.67e-6 * sunlit_rad + corr, air)
    return t_sun + ZEROCELSIUS, t_shade + ZEROCELSIUS


def _acclimation(ha, hd, leaf_t, entropic, opt_t):
    """Kattge & Knorr 2007 peaked Arrhenius (hydrall.cpp:1249-1256)."""
    return (torch.exp(ha * (leaf_t - opt_t) / (opt_t * R_GAS * leaf_t))
            * (1 + torch.exp(div(opt_t * entropic - hd, opt_t * R_GAS)))
            / (1 + torch.exp((leaf_t * entropic - hd) / (leaf_t * R_GAS))))


def farquhar_parameters(leaf_t_k, absorbed_par, lai, kb, kd_par,
                        pressure_pa, last30_t_avg, *,
                        max_carbox_rate=150.0, opt_temp_k=298.15,
                        gs_min=0.02, chlorophyll=500.0, sunlit=True):
    """Big-leaf Farquhar parameters (upscale, hydrall.cpp:1153-1247): a dict
    of vcmax, j (PAR-limited), kc, ko, gamma_star [Pa], rd and gsc_min,
    scaled to the sunlit or shaded big leaf."""
    leaf_t_k = as_f64(leaf_t_k)
    f = lambda v: _f64(v, leaf_t_k)   # noqa: E731
    rt = R_GAS / 1000.0 * leaf_t_k        # [kJ mol-1]
    t_c = leaf_t_k - ZEROCELSIUS
    lai = f(lai)

    if sunlit:
        scale = upscaling_func(f(kb) + kd_par, lai)
    else:
        scale = upscaling_func(f(kd_par), lai) - upscaling_func(f(kb) + kd_par, lai)
    scale = torch.clamp_min(scale, 0.0)

    vcmax_opt = max_carbox_rate * 1e-6
    rd0 = 0.0089 * vcmax_opt
    rd = rd0 * torch.exp(CRD - rdiv(HARD, rt)) * scale

    last30 = f(last30_t_avg)
    s_j = -0.75 * last30 + 660.0
    s_v = -1.07 * last30 + 668.0
    vcmax = vcmax_opt * _acclimation(HAVCM * 1000, HDEACTIVATION * 1000,
                                     leaf_t_k, s_v, opt_temp_k) * scale
    jmax = 1.5 * vcmax_opt * _acclimation(HAJM * 1000, HDEACTIVATION * 1000,
                                          leaf_t_k, s_j, opt_temp_k) * scale

    pressure = f(pressure_pa)
    kc = torch.exp(CKC - rdiv(HAKC, rt)) * 1e-6 * pressure
    ko = torch.exp(CKO - rdiv(HAKO, rt)) * 1e-3 * pressure
    gamma_star = torch.exp(CGSTAR - rdiv(HAGSTAR, rt)) * 1e-6 * pressure

    # PAR limitation by the non-rectangular hyperbola (hydrall.cpp:1222-1240)
    quantum_yield = 0.352 + 0.022 * t_c - 3.4e-4 * sq(t_c)
    convexity = (1 - chlorophyll * 6.93e-4) / 0.98 \
        * (0.76 + 0.018 * t_c - 3.7e-4 * sq(t_c))
    pot = f(absorbed_par) * quantum_yield * 0.5
    s = pot + jmax
    p = pot * jmax
    disc = torch.clamp_min(sq(s) - 4.0 * convexity * p, 0.0)
    j = (s - torch.sqrt(disc)) / (2.0 * torch.clamp_min(convexity, 1e-6))

    return dict(vcmax=vcmax, j=j, kc=kc, ko=ko, gamma_star=gamma_star,
                rd=rd, gsc_min=gs_min * scale)


def _step(c, ci, vpds, rd):
    """One evaluation of the coupled equations (hydrall.cpp:1320-1375) on
    the loop's inputs ``c``: the damped stromal CO2, the leaf-surface VPD,
    the assimilation and the stomatal conductance."""
    pressure_pa, co2_pa, comp, gac = c["pressure_pa"], c["co2_pa"], c["comp"], c["gac"]
    damping = 0.01
    rh = 1.0 - vpds / c["rh_factor"]
    wc = c["vcmax"] * ci / (ci + c["kc"] * c["ko_term"])
    wj = c["j"] * ci / (4.5 * ci + 10.5 * comp)
    vc = torch.minimum(wc, wj)
    ass = torch.clamp_min(vc * (1.0 - comp / torch.clamp_min(ci, 1e-4)), 1e-8)
    cs = co2_pa - pressure_pa * (ass - rd) / gac
    cs = torch.clamp_min(cs, 1e-4)
    cs_mol = torch.clamp_min(cs / pressure_pa * 1e6, 1e-3)
    comp_mol = comp / pressure_pa * 1e6
    # stomatal conductance: the active line of hydrall.cpp:1359
    gsc = c["gscd"] + c["stomwl"] * (ass - rd) * 1e6 / torch.clamp_min(
        cs_mol - comp_mol, 1e-3) * rh
    gsc = torch.clamp_min(gsc, 1e-5)
    ci_new = cs - pressure_pa * (ass - rd) / gsc
    ci_new = torch.minimum(torch.clamp_min(ci_new, 0.01), co2_pa)
    ci_new = damping * ci_new + (1.0 - damping) * ci
    ci_new = torch.minimum(torch.clamp_min(ci_new, 0.01), co2_pa)
    vpds_new = (div(c["slope_sat_vp"], HEAT_CAPACITY_AIR_MOLAR) * c["rni"]
                + c["vpd_pa"] * c["ghr"]) / (c["ghr"] + gsc * c["dum1"])
    return ci_new, vpds_new, ass, gsc


def _iteration(c, s, it):
    """One iteration of the fixed point (JAX's ``body``, hydrall.py:285-298)
    on the carries ``s``, in place: a done cell keeps its values; the
    dark-respiration rescaling and the stop test from the second
    iteration on (``it`` > 0); a newly done cell records ``it`` and its
    |dASS|."""
    ci2, vpds2, ass, gsc = _step(c, s["ci"], s["vpds"], s["rd"])
    later = it > 0
    ratio = torch.clamp(ass / torch.clamp_min(s["ass_old"], 1e-300), 0.1, 10.0)
    rd2 = torch.where(later, s["rd"] * ratio, s["rd"])
    delta = torch.abs(ass - s["ass_old"])
    newly_done = later & (delta <= c["tol"])
    keep = s["done"]
    first = newly_done & ~keep
    torch.where(keep, s["ci"], ci2, out=s["ci"])
    torch.where(keep, s["vpds"], vpds2, out=s["vpds"])
    torch.where(keep, s["rd"], rd2, out=s["rd"])
    torch.where(keep, s["out_ass"], ass, out=s["out_ass"])
    torch.where(keep, s["out_gsc"], gsc, out=s["out_gsc"])
    torch.where(keep, s["out_vpds"], vpds2, out=s["out_vpds"])
    torch.where(keep, s["ass_old"], ass, out=s["ass_old"])
    torch.where(first, it.to(torch.int32), s["stop"], out=s["stop"])
    torch.where(first, delta, s["d_ass"], out=s["d_ass"])
    torch.logical_or(keep, newly_done, out=s["done"])


def photosynthesis_kernel(params, *, co2_pa, vpd_pa, pressure_pa, air_temp_c,
                          rni, slope_sat_vp, psychro_pa,
                          gac=0.5, ghr=0.5, stress=1.0, mi=9.31,
                          max_iter=10000, tol=1e-7, return_stop=False):
    """Coupled assimilation / stomatal conductance / transpiration
    (photosynthesisKernel, hydrall.cpp:1306-1394): damping 0.01 on the
    stromal CO2 update, a per-cell stop at |dASS| <= ``tol`` (each cell
    freezes at its own stopping iterate) and the dark-respiration rescaling
    RD *= clip(ASS/ASSOLD, 0.1, 10).

    Returns (assimilation [mol CO2 m-2 s-1], gsc, transpiration
    [mol H2O m-2 s-1]); with ``return_stop`` also a dict with each cell's
    stop iteration (``stop``, -1 where ``max_iter`` ended the loop first),
    the |dASS| that stopped it (``d_ass``) and the loop's iteration count
    (``iterations``, as JAX's while_loop counts them)."""
    j = as_f64(params["j"])
    f = lambda v: _f64(v, j)   # noqa: E731
    vcmax = f(params["vcmax"])
    kc, ko = f(params["kc"]), f(params["ko"])
    comp = f(params["gamma_star"])
    gscd = f(params["gsc_min"])
    rd0 = f(params["rd"])
    stomwl = mi * f(stress)
    co2_pa, vpd_pa, pressure_pa = f(co2_pa), f(vpd_pa), f(pressure_pa)
    air_temp_c, rni = f(air_temp_c), f(rni)
    slope_sat_vp, psychro_pa = f(slope_sat_vp), f(psychro_pa)

    rh_factor = 613.75 * torch.exp(17.502 * air_temp_c / (240.97 + air_temp_c))
    dum1 = 1.6 * slope_sat_vp / psychro_pa + ghr / gac
    ko_term = 1.0 + rdiv(OSS, ko)

    shape = torch.broadcast_shapes(j.shape, vcmax.shape, rd0.shape,
                                   stomwl.shape, vpd_pa.shape)
    zero = torch.zeros(shape, dtype=torch.float64, device=j.device)
    vpds = torch.broadcast_to(vpd_pa, shape) + zero
    carries = dict(
        ci=torch.broadcast_to(0.7 * co2_pa, shape) + zero, vpds=vpds,
        rd=torch.broadcast_to(rd0, shape) + zero, ass_old=zero, out_ass=zero,
        out_gsc=zero, out_vpds=vpds, d_ass=zero,
        done=torch.zeros(shape, dtype=torch.bool, device=j.device),
        stop=torch.full(shape, -1, dtype=torch.int32, device=j.device))
    named = dict(rh_factor=rh_factor, vcmax=vcmax, kc=kc, ko_term=ko_term, j=j,
                 comp=comp, co2_pa=co2_pa, pressure_pa=pressure_pa, gac=gac, ghr=ghr,
                 gscd=gscd, stomwl=stomwl, slope_sat_vp=slope_sat_vp, rni=rni,
                 vpd_pa=vpd_pa, dum1=dum1, tol=tol)
    out, last = fixed_point.run(
        "hydrall", _iteration,
        {k: v for k, v in named.items() if isinstance(v, torch.Tensor)}, carries,
        {k: v for k, v in named.items() if not isinstance(v, torch.Tensor)}, max_iter)
    out_ass, out_gsc, out_vpds = out["out_ass"], out["out_gsc"], out["out_vpds"]
    stop, d_ass = out["stop"], out["d_ass"]
    # the iterations JAX's loop runs: up to the last cell's stop
    n_iter = last + 1 if last >= 0 else max_iter
    photosynthesis_kernel.iterations += n_iter
    photosynthesis_kernel.calls += 1

    night = j < 1e-7
    ass = where(night, 0.0, out_ass)
    gsc = torch.where(night, gscd + zero, out_gsc)
    vpds = torch.where(night, vpd_pa + zero, out_vpds)
    tr = torch.clamp_min((gsc / 0.64) * vpds / pressure_pa, 1e-8)
    if return_stop:
        return ass, gsc, tr, dict(stop=stop, d_ass=d_ass, iterations=n_iter)
    return ass, gsc, tr


photosynthesis_kernel.iterations = 0
photosynthesis_kernel.calls = 0


def plant_respiration(state: HydrallPlantState, air_temp_c, moisture_factor,
                      opt_temp_k=298.15):
    """Whole-plant maintenance respiration [mol CO2 m-2 s-1]
    (plantRespiration, hydrall.cpp:1542-1600)."""
    n_leaf, n_root, n_stem = 0.02, 0.0078, 0.0021
    leaf = div(RESPIRATION_PARAMETER * state.biomass_foliage * n_leaf, 0.014)
    sap = div(RESPIRATION_PARAMETER * state.biomass_sapwood * n_stem, 0.014)
    root = div(RESPIRATION_PARAMETER * state.biomass_root * n_root, 0.014)

    t_k = _f64(air_temp_c, leaf) + ZEROCELSIUS
    # Lloyd & Taylor 1994 (temperatureFunction, hydrall.cpp:1636-1648)
    t_factor = torch.exp(308.56 * (1.0 / (opt_temp_k + 46.02)
                                   - rdiv(1.0, t_k + 46.02)))
    f = torch.clamp(t_factor * _f64(moisture_factor, leaf), 0.0, 1.0)
    return (leaf + sap + root) * f


def annual_growth(state: HydrallPlantState, *, yearly_prec, yearly_et0,
                  foliage_longevity=4.0, sapwood_longevity=30.0,
                  root_longevity=1.5, root_shoot_ratio_ref=0.25):
    """Annual turnover + NPP allocation (simplifiedGrowthStand,
    hydrall.cpp:1694-1800; management and wildfire options omitted).
    Returns (new_state, litter carbon [kg C m-2]), the litter feeding
    RothC."""
    litter = (div(state.biomass_foliage, foliage_longevity)
              + div(state.biomass_sapwood, sapwood_longevity)
              + div(state.biomass_root, root_longevity)) * CARBON_FACTOR

    foliage = state.biomass_foliage * (1 - 1 / foliage_longevity)
    sapwood = state.biomass_sapwood * (1 - 1 / sapwood_longevity)
    root = state.biomass_root * (1 - 1 / root_longevity)

    growth = div(state.npp_year, CARBON_FACTOR)    # [kg DM m-2]

    alpha = 0.7
    prec = _f64(yearly_prec, foliage)
    et0 = _f64(yearly_et0, foliage)
    aridity = 1.0 - prec / torch.clamp_min(et0, 1e-6)
    rs = torch.clamp(root_shoot_ratio_ref * (alpha * aridity + 1.0),
                     root_shoot_ratio_ref,
                     root_shoot_ratio_ref * (alpha * 0.5 + 1))
    to_root = rs / (1 + rs)
    to_foliage = (1 - to_root) * 0.05
    to_sapwood = 1 - to_root - to_foliage

    new = HydrallPlantState(
        biomass_foliage=torch.clamp_min(foliage + growth * to_foliage, 1e-5),
        biomass_sapwood=torch.clamp_min(sapwood + growth * to_sapwood, 1e-5),
        biomass_root=torch.clamp_min(root + growth * to_root, 1e-5),
        npp_year=torch.zeros_like(state.npp_year))
    return new, litter


# ----------------------------------------------------------------------
# whole-map hourly / daily / annual driver (Crit3DProject::
# computeHydrallModel / dailyUpdateHydrall, criteria3DProject.cpp:634-700,
# 1238-1239, 1827-1915)
# ----------------------------------------------------------------------

# atmospheric CO2 scenario table (getCO2, hydrall.cpp): [year] -> [ppm]
_CO2_YEARS = np.array([1750, 1800, 1850, 1900, 1910, 1920, 1930, 1940, 1950,
                       1960, 1970, 1980, 1990, 2000, 2010, 2020, 2030, 2040,
                       2050, 2060, 2070, 2080, 2090, 2100], dtype=float)
_CO2_PPM = np.array([278, 283, 285, 296, 300, 303, 307, 310, 311, 317, 325,
                     339, 354, 369, 389, 413, 443, 473, 503, 530, 550, 565,
                     570, 575], dtype=float)


def atmospheric_co2_ppm(year: int, doy: int) -> float:
    """Scenario CO2 [ppm] with the seasonal cosine (getCO2, hydrall.cpp);
    host numpy, a Python float."""
    base = float(np.interp(float(year), _CO2_YEARS, _CO2_PPM))
    return base + 3.0 * np.cos(2.0 * np.pi * doy / 365.0)


@dataclasses.dataclass(frozen=True, eq=False)
class HydrallMaps:
    """Forest state maps (hydrallMaps, criteria3DProject.h:135-138): (R, C)
    fields plus the annual accumulators."""

    plant: HydrallPlantState          # biomass pools + npp_year maps
    lai: torch.Tensor                 # [m2 m-2] canopy LAI
    t30_avg: torch.Tensor             # [degC] running ~30-day mean air T
    transpiration_year: torch.Tensor  # [mm]
    prec_year: torch.Tensor
    et0_year: torch.Tensor

    @staticmethod
    def initialize(shape, *, lai=4.0, t_avg=12.0, device=None) -> "HydrallMaps":
        """``device=None`` means the CUDA card."""
        dev = resolve_device(device)

        def f(v):
            return torch.full(tuple(shape), v, dtype=torch.float64, device=dev)

        return HydrallMaps(
            plant=HydrallPlantState.initialize(shape, device=dev),
            lai=f(lai), t30_avg=f(t_avg),
            transpiration_year=f(0.0), prec_year=f(0.0), et0_year=f(0.0))

    def to(self, device) -> "HydrallMaps":
        return map_tensors(self, lambda t: t.to(device))


def hydrall_hour(maps: HydrallMaps, *, air_temp_c, rel_humidity, beam_irr,
                 diffuse_irr, longwave_irr, sun_elevation_deg, pressure_pa,
                 prec_mm, et0_mm, year: int, doy: int, soil_stress=1.0,
                 forest_mask=None) -> tuple[HydrallMaps, dict]:
    """One hour of the HYDRALL forest model over the whole map
    (computeHydrallPoint per forest cell, criteria3DProject.cpp:1827-1915,
    and hydrall.cpp photosynthesisAndTranspiration): sun/shade big-leaf
    absorption, the coupled kernel per leaf class, whole-plant respiration,
    NPP into the annual pool. ``forest_mask`` gates NPP and transpiration
    only. Returns (new_maps, dict(assimilation, transpiration_mm,
    respiration)), inside the profiler range ``c3d.hydrall``."""
    with torch.profiler.record_function(HYDRALL_RANGE):
        return _hydrall_hour(maps, air_temp_c, rel_humidity, beam_irr,
                             diffuse_irr, longwave_irr, sun_elevation_deg,
                             pressure_pa, prec_mm, et0_mm, year, doy,
                             soil_stress, forest_mask)


def _hydrall_hour(maps, air_temp_c, rel_humidity, beam_irr, diffuse_irr,
                  longwave_irr, sun_elevation_deg, pressure_pa, prec_mm,
                  et0_mm, year, doy, soil_stress, forest_mask):
    f = lambda v: _f64(v, maps.lai)   # noqa: E731
    t_air = f(air_temp_c)
    lai = torch.clamp_min(maps.lai, 0.1)
    sin_el = torch.clamp_min(torch.sin(div(f(sun_elevation_deg) * math.pi,
                                           180.0)), 0.0)
    pressure_pa = f(pressure_pa)

    es = 611.0 * torch.exp(17.502 * t_air / (t_air + 240.97))
    rh = torch.clamp(f(rel_humidity), 1.0, 100.0)
    vpd = torch.clamp_min(es * (1.0 - div(rh, 100.0)), 0.0)
    t_c = t_air
    slope_sat = 4098.0 * div(es, 1000.0) / sq(237.3 + t_c) * 1000.0
    psychro = div(1013.0 * pressure_pa, 1000.0) \
        / (0.622 * (2501000.0 - 2369.2 * t_c)) * 1000.0
    co2_pa = atmospheric_co2_ppm(year, doy) * 1e-6 * pressure_pa

    absorbed = big_leaf_radiation(lai, sin_el, f(beam_irr), f(diffuse_irr),
                                  t_air, f(longwave_irr))
    t_sun, t_shade = leaf_temperature(t_air, f(beam_irr), f(diffuse_irr),
                                      vpd, psychro, sin_el)

    assim = torch.zeros_like(lai)
    transp = torch.zeros_like(lai)
    stress = f(soil_stress)
    for sunlit, t_leaf in ((True, t_sun), (False, t_shade)):
        par = absorbed["par_sunlit" if sunlit else "par_shaded"]
        fp = farquhar_parameters(t_leaf, par, lai, absorbed["kb"],
                                 absorbed["kd_par"], pressure_pa,
                                 maps.t30_avg, sunlit=sunlit)
        a, _, tr = photosynthesis_kernel(
            fp, co2_pa=co2_pa, vpd_pa=vpd, pressure_pa=pressure_pa,
            air_temp_c=t_air,
            rni=absorbed["rni_sunlit" if sunlit else "rni_shaded"],
            slope_sat_vp=slope_sat, psychro_pa=psychro, stress=stress)
        assim = assim + a
        transp = transp + tr

    resp = plant_respiration(maps.plant, t_air, stress)
    npp_hour = (assim - resp) * 3600.0 * 12e-3          # [kg C m-2 h-1]
    transp_mm = torch.clamp_min(transp, 0.0) * 3600.0 * 18e-3

    if forest_mask is not None:
        npp_hour = where(forest_mask, npp_hour, 0.0)
        transp_mm = where(forest_mask, transp_mm, 0.0)

    plant = dataclasses.replace(
        maps.plant, npp_year=maps.plant.npp_year + npp_hour)
    new = dataclasses.replace(
        maps, plant=plant,
        transpiration_year=maps.transpiration_year + transp_mm,
        prec_year=maps.prec_year + f(prec_mm),
        et0_year=maps.et0_year + f(et0_mm))
    return new, dict(assimilation=assim, transpiration_mm=transp_mm,
                     respiration=resp)


def hydrall_daily_update(maps: HydrallMaps, t_avg_day) -> HydrallMaps:
    """The ~30-day running mean air temperature feeding the Kattge-Knorr
    acclimation (mapLast30DaysTAvg, criteria3DProject.cpp)."""
    t30 = maps.t30_avg + div(_f64(t_avg_day, maps.t30_avg) - maps.t30_avg, 30.0)
    return dataclasses.replace(maps, t30_avg=t30)


def hydrall_annual_update(maps: HydrallMaps,
                          specific_leaf_area: float = 20.0
                          ) -> tuple[HydrallMaps, torch.Tensor]:
    """Jan-1 annual step (dailyUpdateHydrall, criteria3DProject.cpp:634):
    turnover + NPP allocation, LAI from the new foliage biomass, the annual
    accumulators reset. Returns (new_maps, litter [kg C m-2])."""
    plant, litter = annual_growth(maps.plant,
                                  yearly_prec=maps.prec_year,
                                  yearly_et0=maps.et0_year)
    lai = torch.clamp(plant.biomass_foliage * specific_leaf_area, 0.5, 8.0)
    zero = torch.zeros_like(maps.prec_year)
    return dataclasses.replace(
        maps, plant=plant, lai=lai, transpiration_year=zero,
        prec_year=zero, et0_year=zero), litter

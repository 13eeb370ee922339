"""Grapevine photosynthesis and stomatal transpiration.

PyTorch counterpart of ``criteria3d_tpu/physics/vine_photosynthesis.py``:
VINE3D's own sun/shade big-leaf Farquhar + Wang-Leuning stack
(src/grapevine/grapevine.cpp:385-1020: weatherVariables /
radiationAbsorption / aerodynamicalCoupling / upscale /
photosynthesisKernelSimplified / carbonWaterFluxesProfile). The simplified
fixed point keeps every partial pressure in Pa, pins the leaf-surface CO2
at atmospheric, never updates the leaf-surface VPD and floors the stomatal
conductance at GSCD; the stressed solve is batched over the root layers
(STOMWL = alpha x sawStress[layer]), root-density weighted, with one
unstressed solve for the stress coefficient. Plant height is a parameter
(1.8 m; the reference reads an unset member, DEVIATIONS #24).

The fixed point has a per-cell stop, as JAX's ``lax.while_loop``, and is
a state machine on the device (physics/fixed_point.py): CUDA graphs on the
card, one host read a call; ``CHECK_EVERY`` iterations a unit and a host
read after each on the CPU (iterations of done cells change nothing).
``photosynthesis_kernel_simplified.iterations`` counts the loop iterations
JAX would run (reset it to 0 before a run). Every map is float64.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from criteria3d_tpu_torch.constants import ZEROCELSIUS
from criteria3d_tpu_torch.core.soil import power
from criteria3d_tpu_torch.ops import as_f64, div, ipow, rdiv, sq, where
from criteria3d_tpu_torch.physics import fixed_point
from criteria3d_tpu_torch.physics.fixed_point import CHECK_EVERY

__all__ = [
    "WangLeuningParameters", "atmospheric_co2_pa", "weather_variables",
    "radiation_absorption", "aerodynamic_conductances", "upscale",
    "photosynthesis_kernel_simplified", "carbon_water_fluxes_profile",
    "vine_canopy_fluxes", "plant_respiration", "temperature_moisture_factor",
    "leaf_width_for_stage", "VINE_RANGE", "CHECK_EVERY",
]

# torch.profiler range of the vine canopy fluxes (chip_smoke.py reads it)
VINE_RANGE = "c3d.vine"

# ---- constants (agrolib/crop/biomass.h:7-51, shared Magnani set) ----------
R_GAS = 8.31447215           # [J mol-1 K-1] commonConstants.h:190
GAMMA = 66.2                 # [Pa K-1] psychrometer constant, biomass.h:8
OSS = 21176.0                # [Pa] O2 partial pressure, biomass.h:11
H2O_MOLECULAR_WEIGHT = 0.018  # [kg mol-1] biomass.h:10
CARBON_FACTOR = 0.5          # [kgC kgDM-1] biomass.h:7
HEAT_CAPACITY_AIR_MOLAR = 29.31   # [J mol-1 K-1] commonConstants.h:228
STEFAN_BOLTZMANN = 5.670373e-8    # [W m-2 K-4] commonConstants.h:209
CHL_DEFAULT = 500.0          # [g cm-2] biomass.h:50

HARD, CRD = 46.39, 18.72     # dark-respiration T response, biomass.h:16,24
HAVCM = 65.33                # Vcmax activation energy [kJ mol-1]
HAJM = 43.9                  # Jmax activation energy [kJ mol-1]
HAKC, CKC = 79.43, 38.05     # Kc response
HAKO, CKO = 36.38, 20.30     # Ko response
HAGSTAR, CGSTAR = 37.83, 19.02   # Gamma* response
HDEACTIVATION = 200.0        # [kJ mol-1] Kattge & Knorr 2007


@dataclasses.dataclass(frozen=True)
class WangLeuningParameters:
    """Cultivar Wang-Leuning block (TparameterWangLeuning, grapevine.h:140
    + the fixed part grapevine.cpp:269-281); defaults from the fields DB
    cultivar table (``hydrall_*`` columns, vine3DProject.cpp:252-261;
    alpha is stored as 10 and scaled by 1e5 on load)."""

    max_carbox_rate: float = 115.0        # [umol m-2 s-1] Vcmo at 25 C
    alpha: float = 10.0 * 1.0e5           # Leuning stomatal slope
    vpd_sensitivity: float = 1300.0       # [Pa]
    water_stress_threshold: float = 0.4
    stomatal_conductance_min: float = 0.008   # [mol m-2 s-1]
    optimal_temperature: float = 298.15   # [K]


def _t(v, device) -> torch.Tensor:
    """A number as a 0-d float64 tensor (JAX evaluates jnp.exp / log of a
    number as a float64 array)."""
    return torch.tensor(v, dtype=torch.float64, device=device)


def upscaling_func(k, lai):
    """(1 - exp(-k LAI)) / k  (grapevine.h:24 UPSCALINGFUNC)."""
    return (1.0 - torch.exp(-k * lai)) / k


def atmospheric_co2_pa(year: int, doy, pressure_pa):
    """CO2 partial pressure [Pa] (getCO2, grapevine.cpp:398-411): the Mauna
    Loa exponential fit + the seasonal cosine."""
    dev = pressure_pa.device
    if year < 1990:
        ppm = 280.0 * torch.exp(_t(0.0014876 * (year - 1840), dev))
    else:
        ppm = 350.0 * torch.exp(_t(0.00630 * (year - 1990), dev))
    doy = as_f64(doy, dev)
    ppm = ppm + 3.0 * torch.cos(div(2.0 * math.pi * doy, 365.0))
    return div(ppm * pressure_pa, 1.0e6)


def weather_variables(t_air_c, rh_pct, cloudiness):
    """Derived weather terms (weatherVariables grapevine.cpp:431-437 + the
    VPD from setWeather grapevine.cpp:157-158)."""
    t_k = t_air_c + ZEROCELSIUS
    e = torch.exp(17.502 * t_air_c / (t_air_c + 240.97))
    vp_air = div(611.0 * e * rh_pct, 100.0)
    emissivity_sky = (1.24 * power(div(vp_air, 100.0) / t_k, 1.0 / 7.0)
                      * (1.0 - 0.84 * cloudiness) + 0.84 * cloudiness)
    longwave_irr = ipow(t_k, 4) * emissivity_sky * STEFAN_BOLTZMANN
    slope_sat_vp = (rdiv(2588464.2, sq(240.97 + t_air_c))
                    * torch.exp(17.502 * t_air_c / (240.97 + t_air_c)))
    delta_rh = torch.clamp_min(100.0 - rh_pct, 0.01)
    vpd = 0.01 * delta_rh * 613.75 * torch.exp(
        17.502 * t_air_c / (240.97 + t_air_c))
    return dict(vp_air=vp_air, emissivity_sky=emissivity_sky,
                longwave_irr=longwave_irr, slope_sat_vp=slope_sat_vp,
                vpd=vpd)


def radiation_absorption(lai, sun_elevation_deg, direct_irr, diffuse_irr,
                         t_air_c, longwave_irr, emissivity_sky,
                         chlorophyll=CHL_DEFAULT):
    """Sun/shade big-leaf absorbed PAR + isothermal net radiation
    (radiationAbsorption, grapevine.cpp:441-558; Wang & Leuning 1998).
    Returns the absorbed PAR in mol m-2 s-1 (grapevine.cpp:556-557) and the
    extinction coefficients the upscale step takes."""
    dev = lai.device
    lai = torch.clamp_min(lai, 0.01)
    sine_el = torch.clamp_min(
        torch.sin(sun_elevation_deg * (math.pi / 180.0)), 1.0e-4)
    # hemisphericalIsotropyParameter = 0, clumpingParameter = 1 (statics)
    kb = rdiv(0.5, sine_el)
    kd = rdiv(-1.0, lai) * torch.log(
        0.178 * torch.exp(-(0.5 / 0.259) * lai)
        + 0.514 * torch.exp(-(0.5 / 0.707) * lai)
        + 0.308 * torch.exp(-(0.5 / 0.966) * lai))

    day = sine_el > 0.001
    lai_sun_day = upscaling_func(kb, lai)
    lai_sun = where(day, lai_sun_day, 0.0)
    lai_shade = lai - lai_sun

    # scattering from leaf absorbance; PAR absorbance from chlorophyll
    # (Agusti et al. 1994, grapevine.cpp:479); log10 as jnp.log10
    ten = _t(10.0, dev)
    log10 = torch.log(_t(chlorophyll * 0.85 / 1000.0, dev)) * 0.4342944819032518
    leaf_abs_par = 1.0 - power(ten, -power(ten, 0.28 + 0.63 * log10))
    scat_par = 1.0 - leaf_abs_par
    scat_nir = 1.0 - 0.2          # leafAbsorbanceNIR = 0.2
    sq_par = torch.sqrt(1.0 - scat_par)
    sq_nir = torch.sqrt(_t(1.0 - scat_nir, dev))
    kd_par, kd_nir = kd * sq_par, kd * sq_nir
    kb_par, kb_nir = kb * sq_par, kb * sq_nir

    refl_par = (1.0 - sq_par) / (1.0 + sq_par)
    refl_nir = (1.0 - sq_nir) / (1.0 + sq_nir)
    beam_frac = 2.0 * kb / (kb + kd)
    rho_b_par = rho_b_nir = beam_frac * refl_par
    rho_d_par = rho_d_nir = beam_frac * refl_nir
    # the reference assigns PAR and NIR reflection from the same dum[2] and
    # dum[3] pair (grapevine.cpp:493-494): direct takes the PAR sqrt,
    # diffuse the NIR sqrt

    ib = direct_irr * 0.5          # incoming direct PAR == NIR halves
    idf = diffuse_irr * 0.5

    d5 = idf * (1.0 - rho_d_par) * kd_par
    d6 = ib * (1.0 - rho_b_par) * kb_par
    d7 = ib * (1.0 - scat_par) * kb
    d8 = idf * (1.0 - rho_d_nir) * kd_nir
    d9 = ib * (1.0 - rho_b_nir) * kb_nir
    d10 = ib * (1.0 - scat_nir) * kb_nir
    # dum[10] takes directLightKNIR where the sunlit-PAR analogue d7 takes
    # directLightK (grapevine.cpp:507), as in the reference
    u_kd_kb = upscaling_func(kd_par + kb, lai)
    u_kb_kb = upscaling_func(kb_par + kb, lai)
    u_nir = upscaling_func(kb_nir + kb, lai)
    u_two = upscaling_func(kb, lai) - upscaling_func(2.0 * kb, lai)

    par_sun = d5 * u_kd_kb + d6 * u_kb_kb + d7 * u_two
    par_shade = (d5 * (upscaling_func(kd_par, lai) - u_kd_kb)
                 + d6 * (upscaling_func(kb_par, lai) - u_kb_kb)
                 - d7 * u_two)
    nir_sun = d8 * u_kd_kb + d9 * u_nir + d10 * u_two
    nir_shade = (d8 * (upscaling_func(kd_nir, lai) - u_kd_kb)
                 + d9 * (upscaling_func(kb_nir, lai) - u_nir)
                 - d10 * u_two)

    t_k = t_air_c + ZEROCELSIUS
    lw_net = (longwave_irr - STEFAN_BOLTZMANN * ipow(t_k, 4)) * kd
    em_leaf, em_soil = 0.96, 0.94
    lw_sun = (lw_net * upscaling_func(kb + kd, lai) * em_leaf
              + (1.0 - em_soil) * (em_leaf - emissivity_sky)
              * upscaling_func(2.0 * kd, lai) * upscaling_func(kb - kd, lai))
    lw_shade = lw_net * upscaling_func(kd, lai) - lw_sun

    # night branch (grapevine.cpp:536-552)
    night_lw_shade = lw_net * (upscaling_func(kd, lai)
                               - upscaling_func(kb + kd, lai))
    par_sun = where(day, par_sun, 0.0)
    par_shade = where(day, par_shade, 0.0)
    rni_sun = where(day, par_sun + nir_sun + lw_sun, 0.0)
    rni_shade = torch.where(day, par_shade + nir_shade + lw_shade,
                            night_lw_shade)

    return dict(
        lai_sunlit=lai_sun, lai_shaded=lai_shade,
        par_sunlit=par_sun * 4.57e-6, par_shaded=par_shade * 4.57e-6,
        rni_sunlit=rni_sun, rni_shaded=rni_shade,
        kb=kb, kd=kd, kd_par=kd_par, sine_elevation=sine_el)


def aerodynamic_conductances(wind_speed, lai, plant_height, t_air_c,
                             pressure_pa, lai_sunlit, slope_sat_vp,
                             leaf_width=0.2, amphystomatic=True):
    """Canopy aerodynamic conductances to heat and CO2 [mol m-2 s-1]
    (aerodynamicalCoupling, grapevine.cpp:602-724) at the neutral fixed
    point the reference's Monin-Obukhov loop always ends in (it zeroes both
    big-leaf temperature offsets, grapevine.cpp:705, 713). ``leaf_width``
    is the literal 0.2 the reference feeds the boundary-layer sqrt
    (grapevine.cpp:30, 674)."""
    karm, a_coef, beta = 0.41, 0.0067, 3.0
    wind = torch.clamp_min(wind_speed, 5.0)        # MAXVALUE(5, wind)
    lai = torch.clamp_min(lai, 0.01)
    h_ref = plant_height + 5.0
    dummy = 0.2 * lai
    d0 = torch.minimum(plant_height * (torch.log1p(power(dummy, 0.166))
                                       + 0.03 * torch.log1p(ipow(dummy, 6))),
                       0.99 * plant_height)
    z0 = torch.where(dummy < 0.2,
                     0.01 + 0.28 * torch.sqrt(dummy) * plant_height,
                     0.3 * plant_height * (1.0 - d0 / plant_height))

    ustar = torch.clamp_min(karm * wind / torch.log((h_ref - d0) / z0), 1.0e-4)
    wind_top = torch.clamp_min(
        div(ustar, karm) * torch.log((plant_height - d0) / z0), 1.0e-4)
    g_bl = (a_coef * torch.sqrt(wind_top / leaf_width)
            * ((2.0 / beta) * (1.0 - math.exp(-beta / 2.0))) * lai)
    g_am = ustar / (wind / ustar)              # neutral: the dev funcs cancel
    mol = div(pressure_pa, R_GAS) / (t_air_c + ZEROCELSIUS)
    g_heat = (g_am * g_bl) / (g_am + g_bl) * mol
    frac_sun = lai_sunlit / lai
    g_rad = (4.0 * div(slope_sat_vp, GAMMA)
             * (STEFAN_BOLTZMANN / HEAT_CAPACITY_AIR_MOLAR)
             * ipow(t_air_c + ZEROCELSIUS, 3))
    if amphystomatic:
        g_co2 = 0.78 * g_heat
    else:
        g_co2 = 0.78 * (g_am * g_bl) / (g_bl + 2.0 * g_am) * mol
    return dict(
        g_heat_sunlit=g_heat * frac_sun,
        g_heat_shaded=g_heat * (1.0 - frac_sun),
        g_total_heat_sunlit=(g_heat + g_rad) * frac_sun,
        g_total_heat_shaded=(g_heat + g_rad) * (1.0 - frac_sun),
        g_co2_sunlit=g_co2 * frac_sun,
        g_co2_shaded=g_co2 * (1.0 - frac_sun))


def leaf_width_for_stage(stage, base=0.2):
    """Stage-dependent leaf width (leafWidth, grapevine.cpp:1533-1538):
    0.2x at bud burst, 0.5x at flowering, full otherwise."""
    stage_i = torch.floor(stage)
    return where(stage_i == 2.0, base * 0.2,
                 where(stage_i == 3.0, base * 0.5, base, stage.dtype))


def _acclimation(ha_j, hd_j, leaf_t_k, entropic, opt_t_k):
    """acclimationFunction (grapevine.cpp:414-421), J-mol units."""
    return (torch.exp(ha_j * (leaf_t_k - opt_t_k)
                      / (opt_t_k * R_GAS * leaf_t_k))
            * (1.0 + torch.exp(div(opt_t_k * entropic - hd_j,
                                   opt_t_k * R_GAS)))
            / (1.0 + torch.exp((leaf_t_k * entropic - hd_j)
                               / (leaf_t_k * R_GAS))))


def upscale(rad, leaf_t_sun_k, leaf_t_shade_k, mean_month_t_c, pressure_pa,
            params: WangLeuningParameters, chlorophyll=CHL_DEFAULT):
    """Big-leaf Farquhar parameter upscaling (upscale,
    grapevine.cpp:726-813): per-big-leaf dicts of vcmax, j, kc, ko,
    gamma_star, rd, gsc_min, in Pa partial pressures. At night the shaded
    Vcmax and minimal conductances are recomputed from the clamped sun
    elevation (the reference keeps the last daylight values); the J = 0
    night gate makes assimilation 0 either way."""
    lai = rad["lai_sunlit"] + rad["lai_shaded"]
    kb, kd_par = rad["kb"], rad["kd_par"]
    day = rad["sine_elevation"] > 1.0e-3

    vc_opt = params.max_carbox_rate * 1.0e-6
    rd_t0 = 0.0089 * vc_opt
    dum0 = R_GAS / 1000.0 * leaf_t_sun_k      # [kJ mol-1]
    dum1 = R_GAS / 1000.0 * leaf_t_shade_k
    u_sun = upscaling_func(kb + kd_par, lai)
    u_shade = upscaling_func(kd_par, lai) - u_sun

    rd_sun = rd_t0 * torch.exp(CRD - rdiv(HARD, dum0)) * u_sun
    rd_shade = rd_t0 * torch.exp(CRD - rdiv(HARD, dum1))
    rd_shade = rd_shade * u_shade

    ent_j = -0.75 * mean_month_t_c + 660.0
    ent_v = -1.07 * mean_month_t_c + 668.0
    opt_t = params.optimal_temperature

    gsc_min_sun = params.stomatal_conductance_min * u_sun
    gsc_min_shade = params.stomatal_conductance_min * u_shade

    vcmax_sun = vc_opt * _acclimation(HAVCM * 1000.0, HDEACTIVATION * 1000.0,
                                      leaf_t_sun_k, ent_v, opt_t) * u_sun
    vcmax_shade = vc_opt * _acclimation(HAVCM * 1000.0,
                                        HDEACTIVATION * 1000.0,
                                        leaf_t_shade_k, ent_v, opt_t) * u_shade

    kc_sun = torch.exp(CKC - rdiv(HAKC, dum0)) * 1.0e-6 * pressure_pa
    kc_shade = torch.exp(CKC - rdiv(HAKC, dum1)) * 1.0e-6 * pressure_pa
    ko_sun = torch.exp(CKO - rdiv(HAKO, dum0)) * 1.0e-3 * pressure_pa
    ko_shade = torch.exp(CKO - rdiv(HAKO, dum1)) * 1.0e-3 * pressure_pa
    comp_sun = torch.exp(CGSTAR - rdiv(HAGSTAR, dum0)) * 1.0e-6 * pressure_pa
    comp_shade = torch.exp(CGSTAR - rdiv(HAGSTAR, dum1)) * 1.0e-6 * pressure_pa

    j_opt = 1.5 * vc_opt
    j_sun = j_opt * _acclimation(HAJM * 1000.0, HDEACTIVATION * 1000.0,
                                 leaf_t_sun_k, ent_j, opt_t) * u_sun
    j_shade = j_opt * _acclimation(HAJM * 1000.0, HDEACTIVATION * 1000.0,
                                   leaf_t_shade_k, ent_j, opt_t) * u_shade

    def non_rect(j_big, absorbed_par, t_c):
        quantum = 0.352 + 0.022 * t_c - 3.4e-4 * sq(t_c)
        convexity = ((1.0 - chlorophyll * 6.93e-4) / 0.98
                     * (0.76 + 0.018 * t_c - 3.7e-4 * sq(t_c)))
        i2 = absorbed_par * quantum * 0.5     # BETA = 0.5
        s = i2 + j_big
        p = i2 * j_big
        return (s - torch.sqrt(s * s - 4.0 * convexity * p)) / (2.0 * convexity)

    j_sun = non_rect(j_sun, rad["par_sunlit"], leaf_t_sun_k - ZEROCELSIUS)
    j_shade = non_rect(j_shade, rad["par_shaded"],
                       leaf_t_shade_k - ZEROCELSIUS)

    # night gate (grapevine.cpp:805-811): J and sunlit Vcmax / RD zeroed
    j_sun = where(day, j_sun, 0.0)
    j_shade = where(day, j_shade, 0.0)
    rd_sun = where(day, rd_sun, 0.0)
    vcmax_sun = where(day, vcmax_sun, 0.0)

    sunlit = dict(vcmax=vcmax_sun, j=j_sun, kc=kc_sun, ko=ko_sun,
                  gamma_star=comp_sun, rd=rd_sun, gsc_min=gsc_min_sun)
    shaded = dict(vcmax=vcmax_shade, j=j_shade, kc=kc_shade, ko=ko_shade,
                  gamma_star=comp_shade, rd=rd_shade, gsc_min=gsc_min_shade)
    return sunlit, shaded


def _step(c, cc):
    """One evaluation of photosynthesisKernelSimplified's equations
    (grapevine.cpp:886-915) on the loop's inputs ``c`` (the leaf-surface CO2
    pinned at atmospheric): the new stromal CO2, the assimilation and the
    stomatal conductance."""
    j = torch.broadcast_to(c["j"], torch.broadcast_shapes(c["j"].shape, c["stomwl"].shape))
    cs = torch.broadcast_to(c["co2_pa"], j.shape)
    comp, rd, gscd = c["comp"], c["rd"], c["gscd"]
    wc = c["vcmax"] * cc / (cc + c["kc"] * c["ko_term"])
    wj = j * cc / (4.5 * cc + 10.5 * comp)
    vc = torch.minimum(wc, wj)
    ass = torch.clamp_min(vc * (1.0 - comp / cc), 0.0)
    gsc = gscd + c["stomwl"] * (ass - rd) / (cs - comp) * c["vpd_term"]
    gsc = torch.maximum(gsc, gscd)
    cc_new = torch.clamp_min(cs - c["pressure_pa"] * (ass - rd) / gsc, 1.0e-2)
    return cc_new, ass, gsc


def _iteration(c, s, it):
    """One iteration of the fixed point (JAX's ``body``,
    vine_photosynthesis.py:399-406) on the carries ``s``, in place: a done
    cell keeps its values; a newly done cell records ``it`` and its
    |dASS|."""
    cc2, ass, gsc = _step(c, s["cc"])
    delta = torch.abs(ass - s["ass_old"])
    newly_done = delta <= c["tol"]
    done = s["done"]
    first = newly_done & ~done
    torch.where(done, s["cc"], cc2, out=s["cc"])
    torch.where(done, s["ass_old"], ass, out=s["ass_old"])
    torch.where(done, s["gsc_old"], gsc, out=s["gsc_old"])
    torch.where(first, it.to(torch.int32), s["stop"], out=s["stop"])
    torch.where(first, delta, s["d_ass"], out=s["d_ass"])
    torch.logical_or(done, newly_done, out=s["done"])


def photosynthesis_kernel_simplified(leaf, *, co2_pa, pressure_pa, vpd_pa,
                                     stomwl, vpd_sensitivity,
                                     max_iter=1000, tol=1.0e-7,
                                     return_stop=False):
    """The vine fixed point (photosynthesisKernelSimplified,
    grapevine.cpp:871-925): gross assimilation / stomatal conductance /
    stromal CO2 iterated with the leaf-surface CO2 pinned at atmospheric;
    each cell freezes once its own |dASS| <= ``tol``, as the reference's
    scalar loop (the Leuning slope would carry any further convergence into
    GSC). Returns (assimilation [mol CO2 m-2 s-1], gsc [mol m-2 s-1],
    transpiration [mol H2O m-2 s-1]); with ``return_stop`` also a dict of
    each cell's stop iteration (``stop``; -1 where ``max_iter`` came
    first), the |dASS| that stopped it and the loop's iteration count as
    JAX's while_loop counts it (from 1, the bootstrap step being 0)."""
    j, vcmax = leaf["j"], leaf["vcmax"]
    stomwl = as_f64(stomwl, j.device)
    shape = torch.broadcast_shapes(j.shape, stomwl.shape)
    c = dict(j=j, vcmax=vcmax, kc=leaf["kc"], comp=leaf["gamma_star"], rd=leaf["rd"],
             gscd=leaf["gsc_min"], stomwl=stomwl, co2_pa=co2_pa, pressure_pa=pressure_pa,
             vpd_term=vpd_sensitivity / (vpd_sensitivity + vpd_pa),
             ko_term=1.0 + rdiv(OSS, leaf["ko"]), tol=tol)
    # the bootstrap establishes the first ASSOLD
    cc, ass_old, gsc_old = _step(c, 0.7 * torch.broadcast_to(co2_pa, shape))
    done = torch.zeros(ass_old.shape, dtype=torch.bool, device=j.device)
    carries = dict(cc=cc, ass_old=ass_old, gsc_old=gsc_old, d_ass=torch.zeros_like(ass_old),
                   done=done, stop=torch.full(ass_old.shape, -1, dtype=torch.int32,
                                              device=j.device))
    out, last = fixed_point.run(
        "vine", _iteration, {k: v for k, v in c.items() if isinstance(v, torch.Tensor)},
        carries, {k: v for k, v in c.items() if not isinstance(v, torch.Tensor)},
        max_iter, first_it=1)
    ass_old, gsc_old, stop, d_ass = out["ass_old"], out["gsc_old"], out["stop"], out["d_ass"]
    zero = torch.zeros_like(ass_old)
    n_iter = last if last >= 0 else max_iter - 1
    photosynthesis_kernel_simplified.iterations += n_iter
    photosynthesis_kernel_simplified.calls += 1

    night = j < 1.0e-7
    ass = where(night, 0.0, ass_old)
    gsc = torch.where(night, c["gscd"] + zero, gsc_old)
    tr = torch.clamp_min((gsc / 0.64) * vpd_pa / pressure_pa, 1.0e-8)
    if return_stop:
        return ass, gsc, tr, dict(stop=stop, d_ass=d_ass, iterations=n_iter)
    return ass, gsc, tr


photosynthesis_kernel_simplified.iterations = 0
photosynthesis_kernel_simplified.calls = 0


def carbon_water_fluxes_profile(sunlit, shaded, *, co2_pa, pressure_pa,
                                vpd_pa, alpha, vpd_sensitivity,
                                stress_profile, root_density):
    """Per-root-layer stressed solve + root-density aggregation
    (carbonWaterFluxesProfile grapevine.cpp:953-993, the NoStress variant
    :995-1020 and getStressCoefficient :1043-1055). ``stress_profile`` /
    ``root_density``: a leading layer axis, batched into the kernel.
    Returns the assimilation [mol CO2 m-2 s-1], per-layer transpiration
    [mol H2O m-2 s-1] (L, ...), canopy conductance, the unstressed
    transpiration and the stomatal stress coefficient."""
    stomwl = alpha * stress_profile
    kw = dict(co2_pa=co2_pa, pressure_pa=pressure_pa, vpd_pa=vpd_pa,
              vpd_sensitivity=vpd_sensitivity)
    ass_sun, gsc_sun, tr_sun = photosynthesis_kernel_simplified(
        sunlit, stomwl=stomwl, **kw)
    ass_sh, gsc_sh, tr_sh = photosynthesis_kernel_simplified(
        shaded, stomwl=stomwl, **kw)
    # the sunlit big leaf only where it exists (grapevine.cpp:963-977)
    has_sun = sunlit["j"] + sunlit["vcmax"] > 0.0
    ass_sun = where(has_sun, ass_sun, 0.0)
    gsc_sun = where(has_sun, gsc_sun, 0.0)
    tr_sun = where(has_sun, tr_sun, 0.0)

    assimilation = torch.sum((ass_sun + ass_sh) * root_density, dim=0)
    transp_layer = (tr_sun + tr_sh) * root_density
    total_gs = torch.sum((gsc_sun + gsc_sh) * root_density, dim=0)

    alpha0 = _t(alpha, co2_pa.device)
    a0_sun, g0_sun, t0_sun = photosynthesis_kernel_simplified(
        sunlit, stomwl=alpha0, **kw)
    a0_sh, g0_sh, t0_sh = photosynthesis_kernel_simplified(
        shaded, stomwl=alpha0, **kw)
    g0_sun = where(has_sun, g0_sun, 0.0)
    t0_sun = where(has_sun, t0_sun, 0.0)
    w = torch.sum(root_density, dim=0)
    total_gs_nostress = (g0_sun + g0_sh) * w
    transp_nostress = (t0_sun + t0_sh) * w

    stress_coeff = torch.clamp_min(
        1.0 - where(total_gs_nostress > 0.0,
                    total_gs / torch.clamp_min(total_gs_nostress, 1.0e-30),
                    1.0), 0.0)
    return dict(assimilation=assimilation, transpiration_layer=transp_layer,
                total_stomatal_conductance=total_gs,
                transpiration_nostress=transp_nostress,
                stress_coefficient=stress_coeff)


def vine_canopy_fluxes(*, lai, sun_elevation_deg, direct_irr, diffuse_irr,
                       cloudiness, t_air_c, rh_pct, wind_speed, pressure_pa,
                       mean_month_t_c, stress_profile, root_density,
                       year: int, doy: int,
                       params: WangLeuningParameters = WangLeuningParameters(),
                       plant_height=1.8, chlorophyll=CHL_DEFAULT,
                       stage=None):
    """The photosynthesisAndTranspiration chain (grapevine.cpp:385-396) on
    whole fields, inside the profiler range ``c3d.vine``. Leaf temperatures
    equal air temperature (the reference zeroes both deltas,
    grapevine.cpp:705, 713). ``mean_month_t_c`` may be a number or a map.
    Returns :func:`carbon_water_fluxes_profile`'s dict plus the absorbed
    PAR, the aerodynamic conductances and the VPD."""
    with torch.profiler.record_function(VINE_RANGE):
        lai = as_f64(lai)
        dev = lai.device
        f = lambda v: as_f64(v, dev)   # noqa: E731
        lw = f(0.2) if stage is None else leaf_width_for_stage(f(stage))
        return _canopy_fluxes(
            lai, f(sun_elevation_deg), f(direct_irr), f(diffuse_irr),
            f(cloudiness), f(t_air_c), f(rh_pct), f(wind_speed),
            f(pressure_pa), f(mean_month_t_c), f(stress_profile),
            f(root_density), f(doy), lw, f(plant_height),
            year=year, params=params, chlorophyll=float(chlorophyll))


def _canopy_fluxes(lai, sun_elevation_deg, direct_irr, diffuse_irr,
                   cloudiness, t_air_c, rh_pct, wind_speed, pressure_pa,
                   mean_month_t_c, stress_profile, root_density,
                   doy, leaf_width, plant_height, *,
                   year, params, chlorophyll):
    wx = weather_variables(t_air_c, rh_pct, cloudiness)
    rad = radiation_absorption(lai, sun_elevation_deg, direct_irr,
                               diffuse_irr, t_air_c, wx["longwave_irr"],
                               wx["emissivity_sky"], chlorophyll)
    aero = aerodynamic_conductances(wind_speed, lai, plant_height, t_air_c,
                                    pressure_pa, rad["lai_sunlit"],
                                    wx["slope_sat_vp"],
                                    leaf_width=leaf_width)
    leaf_t = t_air_c + ZEROCELSIUS
    sunlit, shaded = upscale(rad, leaf_t, leaf_t, mean_month_t_c,
                             pressure_pa, params, chlorophyll)
    co2 = atmospheric_co2_pa(year, doy, pressure_pa)
    out = carbon_water_fluxes_profile(
        sunlit, shaded, co2_pa=co2, pressure_pa=pressure_pa, vpd_pa=wx["vpd"],
        alpha=params.alpha, vpd_sensitivity=params.vpd_sensitivity,
        stress_profile=stress_profile, root_density=root_density)
    out.update(absorbed_par=rad["par_sunlit"] + rad["par_shaded"],
               aerodynamics=aero, vpd_pa=wx["vpd"])
    return out


def temperature_moisture_factor(t_k, psi_soil_avg, psi_fc_avg,
                                wilting_point, opt_t_k=298.15):
    """Lloyd & Taylor respiration modifier x soil-moisture correction
    (temperatureMoistureFunction MODEL 2, grapevine.cpp:1116-1167).
    Potentials in kPa, negative down; the potentials may be numbers."""
    dev = t_k.device
    psi, fc, wp = as_f64(psi_soil_avg, dev), as_f64(psi_fc_avg, dev), \
        as_f64(wilting_point, dev)
    moisture = where(
        psi >= fc, 1.0,
        where(psi <= wp, 0.0, torch.log(wp / psi) / torch.log(wp / fc)))
    t_factor = torch.exp(308.56 * (1.0 / (opt_t_k + 46.02)
                                   - rdiv(1.0, t_k + 46.02)))
    return t_factor * moisture


def plant_respiration(*, cumulated_biomass, fruit_biomass, days_after_bloom,
                      t_air_c, mean_month_t_c, psi_soil_avg, psi_fc_avg,
                      wilting_point, opt_t_k=298.15):
    """Hourly whole-vine maintenance respiration [mol CO2 m-2 s-1]
    (plantRespiration, grapevine.cpp:1080-1106; Schreiner 2006 fine-root /
    sapwood biomass, soilTemperatureModel grapevine.cpp:1108-1114)."""
    n_leaf, n_shoot, n_root, n_stem = 0.02, 0.012, 0.0078, 0.0021
    b_leaf = b_shoot = div(cumulated_biomass - fruit_biomass, 2.0)
    dab = torch.clamp_max(days_after_bloom, 1.0)
    b_fine_root = 1.5e-4 * dab
    b_sapwood = 2.0e-4 * dab
    r_leaf = 0.0106 / 2.0 * div(b_leaf * n_leaf, 0.014)
    r_shoot = 0.0106 / 2.0 * div(b_shoot * n_shoot, 0.014)
    r_sap = 0.0106 / 2.0 * div(b_sapwood * n_stem, 0.014)
    r_root = 0.0106 / 2.0 * div(b_fine_root * n_root, 0.014)
    soil_t = 0.8 * as_f64(mean_month_t_c, dab.device) + 0.2 * t_air_c
    r_root = r_root * torch.clamp(
        temperature_moisture_factor(soil_t + ZEROCELSIUS, psi_soil_avg,
                                    psi_fc_avg, wilting_point, opt_t_k),
        0.0, 1.0)
    return div(r_leaf + r_sap + r_root + r_shoot, 3600.0)

"""VINE3D grapevine ecophysiology: phenology, growth, berry quality.

PyTorch counterpart of ``criteria3d_tpu/physics/grapevine.py``, the core of
src/grapevine/grapevine.cpp (Bindi-Miglietta growth + PhenoVitis phenology,
Caffarra & Eccel): the chilling / forcing phenology through endodormancy,
ecodormancy, bud burst, flowering, fruit set, veraison and physiological
maturity (computePhenology, grapevine.cpp:1393-1460); the Bindi-Miglietta
shoot-leaf-number LAI (getLAIVine); fruit biomass from net assimilation
(compute, :69-92); berry quality (Gompertz berry volume, tartaric acid,
:1840-1861); the training systems, root density profiles and the saw-tooth
water stress. Photosynthesis and transpiration are in
:mod:`criteria3d_tpu_torch.physics.vine_photosynthesis`.

Every function is element-wise over maps of any shape; a stage is a float
(integer part the stage, fraction the progress), as the reference's
``statePheno.stage``. ``doy`` is a Python int, as the drivers pass it.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from criteria3d_tpu_torch.constants import NODATA
from criteria3d_tpu_torch.core.soil import power
from criteria3d_tpu_torch.device import map_tensors, resolve_device
from criteria3d_tpu_torch.ops import as_f64, div, rdiv, sq, where

__all__ = ["GrapevineParameters", "GrapevineState", "phenology_daily_step",
           "update_thermal_sum", "lai_vine_daily", "fruit_biomass_step",
           "tartaric_acid", "Stage", "TrainingSystem", "vine_root_density",
           "trapezoid_root_density", "layer_uptake_fractions", "saw_stress"]


class Stage:
    """Phenological stage codes (grapevine.h vine stages)."""

    ENDO_DORMANCY = 0.0
    ECO_DORMANCY = 1.0
    BUD_BURST = 2.0
    FLOWERING = 3.0
    FRUIT_SET = 4.0
    VERAISON = 5.0
    PHYSIOLOGICAL_MATURITY = 6.0
    SENESCENCE = 7.0


@dataclasses.dataclass(frozen=True)
class GrapevineParameters:
    """Cultivar parameters (TVineCultivar; defaults ~ Sangiovese)."""

    # PhenoVitis: defaults = the fields DB 'default' cultivar row
    # (vine3DProject.cpp:240-263 column mapping)
    critical_chilling: float = 78.69
    co1: float = 176.26        # phenovitis_ecodormancy
    co2: float = -0.015        # parameterPhenoVitisFix.co2 (grapevine.cpp:283)
    chilling_a: float = 0.005  # parameterPhenoVitisFix.a
    optimal_chilling_temp: float = 2.8
    critical_force_flowering: float = 24.71
    critical_force_fruitset: float = 34.71
    critical_force_veraison: float = 75.86
    critical_force_maturity: float = 95.71
    degree_days_veraison: float = 2547.0
    starting_doy: int = 244    # phenology year restart (1 Sep)
    # Bindi-Miglietta
    bm_a: float = -0.28
    bm_b: float = 0.04
    bm_c: float = -0.015
    shaded_surface: float = 0.8
    leaf_d: float = 0.0018     # shoot leaf area = d * N^f
    leaf_f: float = 1.34
    shoots_per_plant: float = 10.0
    plant_density: float = 3333.0
    fruit_biomass_offset: float = 0.25
    fruit_biomass_slope: float = 0.01
    lai_min: float = 0.2
    lai_max: float = 6.0
    min_shoot_leaf_nr: float = 1.0


@dataclasses.dataclass(frozen=True, eq=False)
class GrapevineState:
    stage: torch.Tensor              # float stage code
    chilling: torch.Tensor
    force_bud_burst: torch.Tensor
    force_veg: torch.Tensor
    lai: torch.Tensor
    shoot_leaf_number: torch.Tensor
    fruit_biomass: torch.Tensor      # [g m-2]
    cumulated_biomass: torch.Tensor  # [g m-2]
    days_after_bloom: torch.Tensor
    dd_march: torch.Tensor           # [DD] thermal sum from 1 March (NODATA out)
    dd_fruit_set: torch.Tensor       # [DD] thermal sum latched at fruit set
    brix: torch.Tensor               # [Brix] berry sugar (NODATA out of season)
    potential_brix: torch.Tensor     # [Brix] radiation-driven ceiling

    @staticmethod
    def initialize(shape=(), dtype=torch.float64,
                   device=None) -> "GrapevineState":
        """A dormant vine; ``device=None`` means the CUDA card."""
        dev = resolve_device(device)

        def f(v):
            return torch.full(tuple(shape), v, dtype=dtype, device=dev)

        return GrapevineState(
            stage=f(Stage.ENDO_DORMANCY), chilling=f(86.267),
            force_bud_burst=f(0.415), force_veg=f(0.0), lai=f(0.2),
            shoot_leaf_number=f(1.0), fruit_biomass=f(0.0),
            cumulated_biomass=f(0.0), days_after_bloom=f(0.0),
            dd_march=f(NODATA), dd_fruit_set=f(NODATA), brix=f(NODATA),
            potential_brix=f(25.0))

    def to(self, device) -> "GrapevineState":
        return map_tensors(self, lambda t: t.to(device))


def _mask(cond, like: torch.Tensor) -> torch.Tensor:
    """A Python bool or a bool tensor as a bool tensor on ``like``'s
    device (``jnp.where`` takes both)."""
    if isinstance(cond, torch.Tensor):
        return cond
    return torch.tensor(bool(cond), device=like.device)


def chilling_rate(temp, a, c_opt):
    """(grapevine.cpp:1357-1360)."""
    return rdiv(2.0, 1.0 + torch.exp(a * sq(temp - c_opt)))


def force_increment(temp):
    """Daily forcing unit (forceStateFunction, grapevine.cpp:1367-1369)."""
    return rdiv(1.0, 1.0 + torch.exp(-0.26 * (temp - 16.06)))


def update_thermal_sum(state: GrapevineState, mean_daily_temp,
                       after_first_march) -> GrapevineState:
    """Daily thermal-sum bookkeeping before the phenology step
    (updateThermalSum, bin/VINE3D/plant.cpp:378-420): degree days from 1
    March accumulate max(0, Tavg); the sum at fruit set is latched the
    first day the stage reaches fruit set; outside March-November the sum
    is NODATA."""
    t = as_f64(mean_daily_temp, state.stage.device)
    is_fruit_set = state.stage >= Stage.FRUIT_SET
    dd_fs = torch.where(is_fruit_set & (state.dd_fruit_set == NODATA),
                        state.dd_march, state.dd_fruit_set)
    dd = torch.where(state.dd_march == NODATA,
                     torch.clamp_min(t, 0.0),
                     state.dd_march + torch.clamp_min(t, 0.0))
    dd = where(_mask(after_first_march, dd), dd, NODATA)
    return dataclasses.replace(state, dd_march=dd, dd_fruit_set=dd_fs)


def phenology_daily_step(state: GrapevineState, params: GrapevineParameters,
                         mean_daily_temp, doy) -> GrapevineState:
    """One daily PhenoVitis step, the computePhenology state machine
    (grapevine.cpp:1393-1460): chilling (reset on ``starting_doy``), the
    bud-burst forcing once chilled, then past bud burst the vegetative
    forcing with the late-season cold correction, the stage through the
    flowering / fruit-set / veraison sub-segments (fruit set -> veraison by
    the mixed degree-days model), berry brix between veraison and
    senescence, and the 15 November reset to endodormancy."""
    t = as_f64(mean_daily_temp, state.stage.device)

    # entry reset while still in endodormancy (grapevine.cpp:1398-1416)
    pre_eco = state.stage < Stage.ECO_DORMANCY
    state = dataclasses.replace(
        state,
        cumulated_biomass=where(pre_eco, 0.0, state.cumulated_biomass),
        fruit_biomass=where(pre_eco, 0.0, state.fruit_biomass),
        lai=where(pre_eco, 0.01, state.lai),           # LAIMIN
        shoot_leaf_number=where(pre_eco, params.min_shoot_leaf_nr,
                                state.shoot_leaf_number),
        days_after_bloom=where(pre_eco, 0.0, state.days_after_bloom),
        dd_fruit_set=where(pre_eco, NODATA, state.dd_fruit_set),
        dd_march=where(pre_eco, NODATA, state.dd_march))

    chill = where(_mask(doy == params.starting_doy, t), 0.0,
                  state.chilling + chilling_rate(
                      t, params.chilling_a, params.optimal_chilling_temp))

    stage = Stage.ENDO_DORMANCY + torch.clamp_max(
        div(chill, params.critical_chilling), 1.0)

    chilled = chill > params.critical_chilling
    force_bb = torch.where(chilled,
                           state.force_bud_burst + force_increment(t),
                           state.force_bud_burst)
    critical_force = params.co1 * torch.exp(params.co2 * chill)
    stage = torch.where(
        chilled,
        Stage.ECO_DORMANCY + torch.clamp_max(
            1.0 - (critical_force - force_bb)
            / torch.clamp_min(critical_force, 1e-9), 1.0),
        stage)

    # the reference reads criticalForceStateBudBurst uninitialised while the
    # chilling requirement is unmet (grapevine.cpp:1446); guarded here
    burst = chilled & (force_bb > critical_force)

    # vegetative forcing: logistic + late-season cold correction
    # (forceStateFunction(force, T, ddVeraison), grapevine.cpp:1367-1385)
    f_inc = force_increment(t)
    late = (state.dd_march > params.degree_days_veraison) \
        & (state.dd_march != NODATA) & (state.days_after_bloom < 100.0)
    b = where(t < 14.5, 5.0, 1.2)
    cold_corr = -0.05 + rdiv(0.33, 1.0 + power(torch.abs(div(t - 14.5, 4.0)),
                                               2.0 * b))
    force_veg = torch.where(
        burst, state.force_veg + f_inc + where(late, cold_corr, 0.0),
        state.force_veg)

    # sub-segment stage interpolation (grapevine.cpp:1458-1494)
    crit_fl = params.critical_force_flowering
    crit_fs = params.critical_force_fruitset
    crit_ver = params.critical_force_veraison
    crit_mat = params.critical_force_maturity

    stage_bb = Stage.BUD_BURST + div(force_veg, crit_fl)
    stage_fl = Stage.FLOWERING + div(force_veg - crit_fl, crit_fs - crit_fl)
    # fruit set -> veraison: the mixed degree-days model
    stage_fs = where(
        state.dd_fruit_set == NODATA, Stage.FRUIT_SET,
        Stage.FRUIT_SET + (state.dd_march - state.dd_fruit_set)
        / torch.clamp_min(params.degree_days_veraison - state.dd_fruit_set,
                          1e-9))
    stage_ver = Stage.VERAISON + div(force_veg - crit_ver, crit_mat - crit_ver)
    stage_ver = torch.clamp_max(stage_ver, Stage.SENESCENCE)

    stage_veg = torch.where(
        force_veg > crit_ver, stage_ver,
        torch.where(force_veg > crit_fs, stage_fs,
                    torch.where(force_veg > crit_fl, stage_fl, stage_bb)))
    # the fruit-set DD model saturates the vegetative forcing at veraison
    # (grapevine.cpp:1472-1474)
    force_veg = where(burst & (force_veg > crit_fs) & (force_veg <= crit_ver)
                      & (stage_veg >= Stage.VERAISON), crit_ver, force_veg)
    stage = torch.where(burst, stage_veg, stage)

    # berry brix between veraison and senescence (grapevine.cpp:1496-1520)
    in_berry = (stage >= Stage.VERAISON) & (stage < Stage.SENESCENCE)
    brix = where(in_berry,
                 torch.minimum(state.potential_brix,
                               0.28 * (force_veg - crit_ver) + 11.5),
                 NODATA)

    # days after bloom (compute(), grapevine.cpp:94-99)
    dab = torch.where(stage >= Stage.FLOWERING, state.days_after_bloom + 1.0,
                      state.days_after_bloom)

    # 15 November reset (grapevine.cpp:1522-1532); the bloom counter resets
    # in the entry block of the next call, once the stage is below
    # ecodormancy (grapevine.cpp:1398-1411)
    nov15 = _mask(doy == 320, t)
    stage = where(nov15, Stage.ENDO_DORMANCY, stage)
    force_bb = where(nov15, 0.0, force_bb)
    force_veg = where(nov15, 0.0, force_veg)
    brix = where(nov15, NODATA, brix)
    dd_fs = where(nov15, NODATA, state.dd_fruit_set)
    dd_march = where(nov15, NODATA, state.dd_march)

    return dataclasses.replace(state, stage=stage, chilling=chill,
                               force_bud_burst=force_bb, force_veg=force_veg,
                               days_after_bloom=dab, brix=brix,
                               dd_fruit_set=dd_fs, dd_march=dd_march)


def lai_vine_daily(state: GrapevineState, params: GrapevineParameters,
                   mean_daily_temp, doy, stress_coefficient=1.0
                   ) -> GrapevineState:
    """Daily Bindi-Miglietta LAI update (getLAIVine)."""
    t = as_f64(mean_daily_temp, state.stage.device)
    veg = state.stage >= Stage.BUD_BURST
    n = torch.clamp_min(state.shoot_leaf_number, params.min_shoot_leaf_nr)

    rate = torch.clamp_min(
        (params.bm_a + params.bm_b * t) * (1.0 + params.bm_c * n), 0.0)
    rate = where(_mask(doy < 260, rate), rate, 0.0)
    ripening = (state.stage >= Stage.VERAISON) \
        & (state.stage <= Stage.PHYSIOLOGICAL_MATURITY)
    rate = torch.where(
        ripening,
        rate * (1.0 - (params.fruit_biomass_offset
                       + params.fruit_biomass_slope * state.days_after_bloom)),
        rate)

    n_new = torch.where(veg, n + rate, n)
    shoot_leaf_area = params.leaf_d * power(n_new, params.leaf_f)
    lai_unstressed = div(shoot_leaf_area * params.shoots_per_plant
                         * params.plant_density, params.shaded_surface)

    delta = torch.clamp_min(lai_unstressed - state.lai, 0.0) \
        * stress_coefficient
    lai = torch.clamp_max(state.lai + delta, params.lai_max)

    # senescence decay toward LAImin after maturity / mid autumn
    decay = (state.stage >= Stage.PHYSIOLOGICAL_MATURITY) | (doy > 273)
    delta_doy = max(320 - doy, 1)
    lai = torch.where(decay,
                      torch.clamp_min(lai * (1.0 - 1.0 / delta_doy),
                                      params.lai_min),
                      lai)
    lai = where(veg, lai, params.lai_min)

    return dataclasses.replace(state, lai=lai, shoot_leaf_number=n_new)


def fruit_biomass_step(state: GrapevineState, params: GrapevineParameters,
                       net_assimilation_g) -> GrapevineState:
    """Allocate net assimilation to total and fruit biomass (compute,
    grapevine.cpp:69-92): after fruit set the fruit share of new biomass
    is offset + slope min(80, daysAfterBloom - 5)."""
    dab = state.days_after_bloom
    net = as_f64(net_assimilation_g, dab.device)
    ratio = params.fruit_biomass_slope * params.shoots_per_plant / 11.0
    partition = params.fruit_biomass_offset + ratio * torch.clamp_max(
        torch.clamp_min(dab - 5.0, 0.0), 80.0)

    fruiting = (dab >= 5.0) & (state.stage <= Stage.PHYSIOLOGICAL_MATURITY) \
        & (state.stage >= Stage.FRUIT_SET)
    fruit = torch.where(fruiting, state.fruit_biomass + net * partition,
                        state.fruit_biomass)
    total = state.cumulated_biomass + torch.clamp_min(net, 0.0)
    return dataclasses.replace(state, fruit_biomass=fruit,
                               cumulated_biomass=total)


def gompertz_berry_volume(stage_from_veraison):
    """(gompertzDistribution, grapevine.cpp:1853-1861)."""
    a = torch.tensor(2.5, dtype=torch.float64, device=stage_from_veraison.device)
    b = torch.log(a)
    c = -torch.log(-torch.log(torch.full_like(a, 0.76)) / b)
    return a * torch.exp(-b * torch.exp(-c * stage_from_veraison))


def tartaric_acid(state: GrapevineState):
    """[g/L]-scale index, diluted by berry growth (getTartaricAcid,
    grapevine.cpp:1840-1851); NaN before veraison."""
    past = state.stage >= Stage.VERAISON
    vol = gompertz_berry_volume(
        torch.clamp_min(state.stage - Stage.VERAISON, 0.0) + 0.2)
    return where(past, rdiv(1.0, vol), math.nan)


# ----------------------------------------------------------------------
# training systems + root density profiles (grapevine.h:183-210,
# grapevine.cpp:1192-1280, 1656-1690)
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrainingSystem:
    """TtrainingSystem (grapevine.h:183-190), the fields DB
    ``training_system`` table."""

    id: int = 0
    name: str = "default"
    shoots_per_plant: float = 8.0
    row_width: float = 0.4
    row_height: float = 1.5
    row_distance: float = 3.0
    plant_distance: float = 1.0

    @property
    def plant_density(self) -> float:
        """plants per m2 (readFieldQuery, vine3DProject.cpp:629)."""
        return 1.0 / (self.row_distance * self.plant_distance)

    @property
    def shaded_surface(self) -> float:
        """canopy-shaded ground fraction (row footprint / row spacing)."""
        return self.row_width / self.row_distance


def vine_root_density(n_layers: int, n_layers_with_root: int,
                      n_upper_layers_without_root: int = 1,
                      shape_factor: float = 2.0) -> np.ndarray:
    """Cardioid ("lunette") vine root density profile, normalised to 1:
    Vine3D_Grapevine::setRootDensity's CARDIOID_DISTRIBUTION branch
    (grapevine.cpp:1192-1242). Host numpy."""
    nr = n_layers_with_root
    lunette = np.zeros(nr)
    for i in range(nr):
        sin_a = 1.0 - (1 + i) / nr
        cos_a = max(np.sqrt(1.0 - sin_a ** 2), 1e-4)
        alfa = np.arctan2(sin_a, cos_a)
        lunette[i] = ((np.pi / 2) - alfa - sin_a * cos_a) / np.pi
    density = np.zeros(2 * nr)
    density[0] = density[2 * nr - 1] = lunette[0]
    for i in range(1, nr):
        density[i] = density[2 * nr - i - 1] = lunette[i] - lunette[i - 1]

    li_min = -np.log(0.2) / nr
    li_max = -np.log(0.05) / nr
    k = li_min + (li_max - li_min) * (shape_factor - 1.0)
    density *= np.exp(-k * (np.arange(2 * nr) + 0.5))
    density /= density.sum()

    roots = np.zeros(n_layers)
    for i in range(nr):
        li = n_upper_layers_without_root + i
        if li < n_layers:
            roots[li] = density[2 * i] + density[2 * i + 1]
    return roots


def trapezoid_root_density(layer_depth, layer_thickness,
                           start_root_depth: float, total_root_depth: float,
                           coarse_fragments=0.0) -> np.ndarray:
    """Grass / fallow trapezoidal root profile, normalised to 1
    (getTrapezoidRoots, grapevine.cpp:1656-1690). Host numpy."""
    depth = np.asarray(layer_depth, dtype=float)
    thick = np.asarray(layer_thickness, dtype=float)
    coarse = np.broadcast_to(np.asarray(coarse_fragments, float), depth.shape)
    upper = depth - thick * 0.5
    lower = depth + thick * 0.5
    m = -2.0 / total_root_depth ** 2
    q = 2.0 / total_root_depth
    x1 = np.maximum(start_root_depth, upper)
    x2 = np.minimum(total_root_depth, lower)
    y = (m * x1 + q) + (m * x2 + q)
    roots = np.where((upper > total_root_depth) | (lower < start_root_depth),
                     0.0, y * np.abs(x2 - x1) * 0.5 * (1.0 - coarse))
    s = roots.sum()
    return roots / s if s > 0 else roots


def layer_uptake_fractions(root_density, saw_stress):
    """Per-layer share of a transpiration demand: root density times the
    saw-tooth water-stress coefficient ``saw_stress`` (:func:`saw_stress`'s
    profile), renormalised over the layer axis."""
    w = root_density * saw_stress
    s = torch.sum(w, dim=0, keepdim=True)
    return where(s > 0, w / torch.clamp_min(s, 1e-12), 0.0)


def saw_stress(fraction_transpirable, threshold: float = 0.4):
    """Saw-tooth water-stress coefficient per layer
    (getWaterStressSawFunction, grapevine.cpp:1548-1554): 1 above the
    cultivar threshold of the fraction of transpirable soil water, linear
    below."""
    ftsw = as_f64(fraction_transpirable)
    return where(ftsw > threshold, 1.0, div(ftsw, threshold))

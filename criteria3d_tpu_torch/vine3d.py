"""VINE3D orchestration: Vine3DProject::modelDailyCycle in PyTorch.

PyTorch counterpart of ``criteria3d_tpu/vine3d.py``, the vineyard variant
of the hourly cycle (bin/VINE3D/modelCore.cpp:90-271, vine3DProject.cpp):

1. radiation, ET0 and leaf wetness (computeLeafWetnessMap,
   project/meteoMaps.cpp:274-297);
2. grapevine photosynthesis on the sun/shade big leaf, per-layer stomatal
   transpiration under the saw-tooth water stress (grapevine.cpp:816-1052),
   inside the profiler range ``c3d.vine``;
3. field-book operations (fieldBookAction, grapevine.cpp:341-372):
   irrigation, trimming, leaf removal, cluster thinning, harvesting;
4. hourly irrigation (assignIrrigation, modelCore.cpp:43-88: a booking
   runs in the day's last ``quantity`` hours at the field's max rate);
5. the disease models, downy mildew hourly and powdery mildew daily, inside
   the profiler range ``c3d.diseases``;
6. the daily PhenoVitis phenology, Bindi-Miglietta LAI and fruit biomass;
7. the shared surface-subsurface water step (``compute_period_stats``).

The orchestration is host Python; every map is a tensor on the grid's
device. Each hour reads the MBR to the host, and each day the bud-break
flag and the catchment mean temperature, as JAX does (``host_read``).
"""

from __future__ import annotations

import dataclasses
import datetime

import numpy as np
import torch

from criteria3d_tpu_torch.constants import HOUR_SECONDS
from criteria3d_tpu_torch.core.grid import Grid
from criteria3d_tpu_torch.core.soil import power, theta_from_se
from criteria3d_tpu_torch.core.state import SolverParameters, WaterState
from criteria3d_tpu_torch.device import host_array, host_read
from criteria3d_tpu_torch.model import HourlyForcing, ModelConfig, _on, masked_mean
from criteria3d_tpu_torch.ops import as_f64, div, where
from criteria3d_tpu_torch.physics import crop as crop_mod
from criteria3d_tpu_torch.physics import grapevine as gv
from criteria3d_tpu_torch.physics import meteo as meteo_mod
from criteria3d_tpu_torch.physics import radiation as rad_mod
from criteria3d_tpu_torch.physics import vine_photosynthesis as vp
from criteria3d_tpu_torch.physics.downy_mildew import (DownyMildewInput,
                                                       DownyMildewState,
                                                       downy_mildew_step)
from criteria3d_tpu_torch.physics.powdery_mildew import (PowderyMildewState,
                                                         powdery_mildew_step)
from criteria3d_tpu_torch.solver import water as W
from criteria3d_tpu_torch.solver.step import (compute_period_stats,
                                              initialize_balance)

__all__ = ["FieldOperation", "FieldBookEntry", "Vine3DModel",
           "DISEASES_RANGE"]

# torch.profiler range of the two disease steps (chip_smoke.py reads it)
DISEASES_RANGE = "c3d.diseases"

# RH threshold of the dichotomic leaf-wetness rule
# (computeLeafWetness, agrolib/meteo/meteo.cpp:444-454)
LEAF_WETNESS_RH_THRESHOLD = 87.0


class FieldOperation:
    """TfieldOperation (grapevine.h)."""

    IRRIGATION = "irrigation"
    GRASS_SOWING = "grassSowing"
    GRASS_REMOVING = "grassRemoving"
    TRIMMING = "trimming"
    LEAF_REMOVAL = "leafRemoval"
    CLUSTER_THINNING = "clusterThinning"
    HARVESTING = "harvesting"
    TARTARIC_ANALYSIS = "tartaricAnalysis"


@dataclasses.dataclass(frozen=True)
class FieldBookEntry:
    """One agronomic operation booked on a field (TfieldBook,
    vine3DProject.h; the 'field_book' DB table)."""

    date: datetime.date
    field_index: int
    operation: str
    quantity: float = 0.0        # hours for irrigation, % for thinning, ...


@dataclasses.dataclass
class Vine3DModel:
    """Vineyard model state + hourly driver (the Vine3DProject model).

    ``field_map`` assigns each DEM cell a field index (the reference's
    modelCase index map; host numpy); field-book operations and irrigation
    apply to the matching cells only.
    """

    grid: Grid
    params: SolverParameters
    config: ModelConfig
    water: WaterState
    vine_params: gv.GrapevineParameters
    vine: gv.GrapevineState                  # (R,C) maps
    vine_crop: crop_mod.CropParameters       # root/uptake parameters (vine)
    grass_crop: crop_mod.CropParameters      # inter-row grass cover
    field_map: np.ndarray                    # (R,C) int field index, -1 = none
    field_book: list
    downy: DownyMildewState
    powdery: PowderyMildewState
    max_irrigation_rate: float = 2.0         # [mm h-1]
    grass_lai: float = 1.0
    training: gv.TrainingSystem | None = None
    # cultivar Wang-Leuning block from the fields DB (hydrall_* columns,
    # vine3DProject.cpp:252-261); None = defaults
    wang_leuning: vp.WangLeuningParameters | None = None
    # cells whose model case is a vineyard (isVineyard,
    # vine3DProject.cpp:1410-1413); None = everywhere. Other cells keep the
    # inter-row grass + bare-soil fluxes only.
    vineyard_mask: torch.Tensor | None = None
    # ini [settings] compute_diseases (the reference app gates
    # computeDiseases in modelDailyCycle)
    compute_diseases: bool = True
    vine_root_density: torch.Tensor | None = None    # (L,) cardioid profile
    grass_root_density: torch.Tensor | None = None   # (L,) trapezoid profile
    water_stress_threshold: float = 0.4      # cultivar FTSW saw threshold
    harvested: torch.Tensor | None = None    # (R,C) bool
    stress: torch.Tensor | None = None       # (R,C) last stress coefficient
    # daily accumulators (reset by daily_update)
    _tsum: object = 0.0          # (R,C) per-cell daily accumulators
    _tmin: object = 1e9
    _tmax: object = -1e9
    _nhours: int = 0
    _rain_mm: torch.Tensor | None = None
    _wet_hours: torch.Tensor | None = None
    _rh_sum: torch.Tensor | None = None
    _assim_gm2: torch.Tensor | None = None   # daily net assimilation [g m-2]
    _irrigation_hours: dict | None = None    # field_index -> booked hours
    _t30_avg: object = 15.0                  # running ~30-day mean T [degC]

    @staticmethod
    def create(grid: Grid, params: SolverParameters, config: ModelConfig,
               *, matric_potential=-2.0,
               vine_params: gv.GrapevineParameters | None = None,
               field_map: np.ndarray | None = None,
               field_book: list | None = None,
               training: gv.TrainingSystem | None = None) -> "Vine3DModel":
        """Initial states on the grid's device: a dormant vine, no disease;
        without ``field_map`` every valid cell is field 0 (the mask is read
        to the host)."""
        dev = grid.device
        shape2d = tuple(grid.shape[1:])
        water = WaterState.initialize(grid, params,
                                      matric_potential=matric_potential,
                                      device=dev)
        water = initialize_balance(grid, params, water)
        if field_map is None:
            field_map = np.where(host_array(grid.mask[0]), 0, -1)
        # vine roots: deep cardioid; grass: shallow
        vine_crop = crop_mod.CropParameters(
            root_depth_max=1.5, kc_max=1.1, f_raw=0.4)
        grass_crop = crop_mod.CropParameters(
            root_depth_max=0.3, kc_max=0.8, f_raw=0.5)

        # per-layer root profiles (setRootDensity CARDIOID /
        # setGrassRootDensity trapezoid, grapevine.cpp:1192-1290,1677-1690);
        # the layer geometry is host data
        L = grid.n_layers
        n_root = max(L - 2, 1)         # all soil layers below the first
        vine_roots = gv.vine_root_density(L, n_root,
                                          n_upper_layers_without_root=1)
        grass_roots = gv.trapezoid_root_density(
            np.asarray(grid.layer_depth), np.asarray(grid.layer_thickness),
            0.02, min(0.3, float(grid.layer_depth[-1])))

        vpar = vine_params or gv.GrapevineParameters()
        if training is not None:
            # geometry from the training system (readFieldQuery,
            # vine3DProject.cpp:625-633)
            vpar = dataclasses.replace(
                vpar, shoots_per_plant=training.shoots_per_plant,
                plant_density=training.plant_density * 10000.0,
                shaded_surface=training.shaded_surface)

        def zeros():
            return torch.zeros(shape2d, dtype=torch.float64, device=dev)

        return Vine3DModel(
            grid=grid, params=params, config=config, water=water,
            vine_params=vpar,
            vine=gv.GrapevineState.initialize(shape2d, device=dev),
            vine_crop=vine_crop, grass_crop=grass_crop,
            training=training,
            vine_root_density=torch.tensor(vine_roots, dtype=torch.float64,
                                           device=dev),
            grass_root_density=torch.tensor(grass_roots, dtype=torch.float64,
                                            device=dev),
            field_map=field_map, field_book=list(field_book or []),
            downy=DownyMildewState.initialize(shape2d, device=dev),
            powdery=PowderyMildewState.initialize(shape2d, device=dev),
            harvested=torch.zeros(shape2d, dtype=torch.bool, device=dev),
            stress=zeros(),
            _rain_mm=zeros(), _wet_hours=zeros(), _rh_sum=zeros(),
            _assim_gm2=zeros(), _irrigation_hours={},
        )

    # ------------------------------------------------------------------
    def _field_mask(self, field_index: int) -> torch.Tensor:
        return torch.as_tensor(np.asarray(self.field_map) == field_index,
                               device=self.grid.device)

    def apply_field_book(self, date: datetime.date) -> None:
        """Apply the day's booked operations (checked at hour 1,
        modelCore.cpp:204-216; fieldBookAction, grapevine.cpp:341-372)."""
        p = self.vine_params
        self._irrigation_hours = {}
        for entry in self.field_book:
            if entry.date != date:
                continue
            m = self._field_mask(entry.field_index)
            v = self.vine
            if entry.operation in (FieldOperation.TRIMMING,
                                   FieldOperation.LEAF_REMOVAL):
                n = torch.where(m, torch.clamp_min(
                    v.shoot_leaf_number - entry.quantity,
                    p.min_shoot_leaf_nr), v.shoot_leaf_number)
                shoot_area = p.leaf_d * power(n, p.leaf_f)
                lai = div(shoot_area * p.shoots_per_plant * p.plant_density,
                          p.shaded_surface)
                self.vine = dataclasses.replace(
                    v, shoot_leaf_number=n,
                    lai=torch.where(m, torch.clamp(lai, p.lai_min, p.lai_max),
                                    v.lai))
            elif entry.operation == FieldOperation.CLUSTER_THINNING:
                f = 0.01 * (100.0 - entry.quantity)
                self.vine = dataclasses.replace(
                    v, fruit_biomass=torch.where(m, v.fruit_biomass * f,
                                                 v.fruit_biomass))
            elif entry.operation == FieldOperation.HARVESTING:
                self.harvested = self.harvested | m
            elif entry.operation == FieldOperation.IRRIGATION:
                self._irrigation_hours[entry.field_index] = entry.quantity

    def hourly_irrigation(self, hour: int) -> torch.Tensor:
        """Irrigation map [mm h-1]: booked fields irrigate in the last
        ``quantity`` hours of the day (assignIrrigation,
        modelCore.cpp:43-88)."""
        irr = torch.zeros(tuple(self.grid.shape[1:]), dtype=torch.float64,
                          device=self.grid.device)
        for field_index, nr_hours in (self._irrigation_hours or {}).items():
            if hour >= 24 - nr_hours:
                irr = where(self._field_mask(field_index),
                            self.max_irrigation_rate, irr)
        return irr

    # ------------------------------------------------------------------
    def _grapevine_fluxes(self, air_t, rh, wind, trans, rad, saw_profile,
                          year: int, doy: int) -> dict:
        """Whole-map photosynthesis + stomatal transpiration through the
        vine's own sun/shade stack (photosynthesisAndTranspiration,
        grapevine.cpp:385-396): the simplified kernel solved per root layer
        with STOMWL = alpha x sawStress[layer], root-density weighted
        (carbonWaterFluxesProfile, grapevine.cpp:953-993)."""
        cfg = self.config
        dem2d = self.grid.z[0]
        lai = where(self.harvested, self.vine_params.lai_min, self.vine.lai)
        rh = torch.clamp(rh, 1.0, 100.0)
        pressure = meteo_mod.pressure_from_altitude(dem2d)            # [Pa]
        # cloudIndex from the transmissivity ratio
        cloud = torch.clamp(1.0 - div(trans, cfg.clear_sky_transmissivity),
                            0.0, 1.0)

        out = vp.vine_canopy_fluxes(
            lai=lai, sun_elevation_deg=rad.sun["elevation_refr"],
            direct_irr=rad.beam, diffuse_irr=rad.diffuse,
            cloudiness=cloud, t_air_c=air_t, rh_pct=rh,
            wind_speed=wind, pressure_pa=pressure,
            mean_month_t_c=self._t30_avg,
            stress_profile=saw_profile,
            root_density=self.vine_root_density[:, None, None],
            year=year, doy=doy,
            params=self.wang_leuning or vp.WangLeuningParameters(
                water_stress_threshold=self.water_stress_threshold),
            stage=self.vine.stage)

        respiration = vp.plant_respiration(
            cumulated_biomass=div(self.vine.cumulated_biomass, 1000.0),  # [kg]
            fruit_biomass=div(self.vine.fruit_biomass, 1000.0),
            days_after_bloom=self.vine.days_after_bloom,
            t_air_c=air_t, mean_month_t_c=self._t30_avg,
            psi_soil_avg=-100.0, psi_fc_avg=-33.0, wilting_point=-1500.0)
        # net assimilation, mol CO2 m-2 h-1 -> g DM m-2 h-1
        # (cumulatedResults, grapevine.cpp:1057-1078: x12 g/mol, /CARBONFACTOR)
        assim_g = div((out["assimilation"] - respiration) * 3600.0 * 12.0,
                      vp.CARBON_FACTOR)
        # per-layer transpiration mol m-2 s-1 -> mm h-1: x3600 s, x0.018
        # kg mol-1 gives kg m-2 == mm (cumulatedResults, grapevine.cpp:1073)
        transp_layer_mm = (3600.0 * vp.H2O_MOLECULAR_WEIGHT
                           * out["transpiration_layer"])
        return dict(assimilation_g=assim_g,
                    transpiration_layer_mm=transp_layer_mm,
                    transpiration_mm=torch.sum(transp_layer_mm, dim=0),
                    stress_coefficient=out["stress_coefficient"],
                    lai=lai)

    # ------------------------------------------------------------------
    def _thickness(self) -> torch.Tensor:
        return torch.tensor(self.grid.layer_thickness, dtype=torch.float64,
                            device=self.grid.device)[:, None, None]

    def _layer_uptake(self, demand_mm, root_density, saw, theta, theta_wp):
        """(sink [m3 s-1] (L,R,C), actual [mm] (R,C)): the demand shared
        over the layers by root density x saw stress, bounded by each
        layer's water above the wilting point."""
        grid = self.grid
        frac = gv.layer_uptake_fractions(root_density[:, None, None], saw)
        layer_t = demand_mm[None] * frac                       # [mm]
        avail_mm = torch.clamp_min(theta - theta_wp, 0.0) * self._thickness() \
            * 1000.0
        layer_t = torch.minimum(layer_t, avail_mm)
        layer_t = where(grid.mask, layer_t, 0.0)
        layer_t[0] = 0.0
        sink = div(-grid.area * div(layer_t, 1000.0), HOUR_SECONDS)
        return sink, torch.sum(layer_t, dim=0)

    # ------------------------------------------------------------------
    def run_hour(self, forcing: HourlyForcing, year: int, month: int,
                 day: int, hour: int) -> dict:
        """One hour of the vineyard cycle (modelDailyCycle body). Returns
        diagnostics: tensors on the grid's device, the MBR as a host float
        and ``solver_stats``, the water period's host ints (steps,
        attempts, approximations, inner iterations)."""
        grid, params, cfg = self.grid, self.params, self.config
        date = datetime.date(year, month, day)
        valid = grid.mask[0]
        dem2d = grid.z[0]
        shape = tuple(dem2d.shape)
        air_t = _on(grid, forcing.air_temperature, shape)
        prec = _on(grid, forcing.precipitation, shape)
        rh = _on(grid, forcing.rel_humidity, shape)
        wind = _on(grid, forcing.wind_speed, shape)
        trans = _on(grid, forcing.transmissivity, shape)
        out = {}

        if hour == 1:
            self.apply_field_book(date)

        # ---- radiation + ET0 + leaf wetness
        zeros = torch.zeros_like(dem2d)
        rad = rad_mod.compute_radiation_dem(
            dem2d, valid, grid.cell_size,
            torch.full_like(dem2d, cfg.latitude),
            torch.full_like(dem2d, cfg.longitude), zeros, zeros,
            cfg.timezone, year, month, day, hour,
            linke=cfg.linke, albedo=cfg.albedo,
            clear_sky_transmissivity=cfg.clear_sky_transmissivity,
            transmissivity=trans)
        norm_trans = div(trans, cfg.clear_sky_transmissivity)
        et0 = meteo_mod.et0_penman_hourly(dem2d, norm_trans, rad.global_irr,
                                          air_t, rh, wind)
        et0 = where(valid, et0, 0.0)
        leaf_wetness = ((prec > 0) | (rh > LEAF_WETNESS_RH_THRESHOLD)
                        ).to(torch.float32)
        out["et0"] = et0
        out["leaf_wetness"] = leaf_wetness

        # ---- soil-moisture stress profile (initializeWaterStress,
        # grapevine.cpp:182-187: saw-tooth on the fraction of transpirable
        # soil water, before photosynthesis)
        se = W.compute_se(grid, params, self.water.h)
        theta = where(grid.mask, theta_from_se(grid.soil, se), 0.0)
        _, theta_fc, theta_wp, _ = crop_mod.water_content_thresholds(
            grid, params)
        ftsw = torch.clamp((theta - theta_wp)
                           / torch.clamp_min(theta_fc - theta_wp, 1e-9),
                           0.0, 1.0)
        saw = gv.saw_stress(ftsw, self.water_stress_threshold)
        saw = where(grid.mask, saw, 0.0)

        # ---- grapevine photosynthesis / per-layer stomatal transpiration
        doy = date.timetuple().tm_yday
        fluxes = self._grapevine_fluxes(air_t, rh, wind, trans, rad, saw,
                                        year, doy)
        vy = valid if self.vineyard_mask is None \
            else (valid & self.vineyard_mask)
        self._assim_gm2 = self._assim_gm2 + where(
            vy, fluxes["assimilation_g"], 0.0)
        out["vine_transpiration_demand"] = fluxes["transpiration_mm"]

        # vine: the kernel's per-layer transpiration is the extraction
        # (modelCore.cpp:220-226 getExtractedWater -> waterSinkSource),
        # capped at the extractable water per layer
        avail_mm = torch.clamp_min(theta - theta_wp, 0.0) * self._thickness() \
            * 1000.0
        layer_v = torch.minimum(fluxes["transpiration_layer_mm"], avail_mm)
        layer_v = where(grid.mask, layer_v, 0.0)
        layer_v[0] = 0.0
        if self.vineyard_mask is not None:
            # grapevine runs only on vineyard model cases
            # (modelDailyCycle gates on isVineyard, modelCore.cpp:219)
            layer_v = where(self.vineyard_mask[None], layer_v, 0.0)
        sink_v = div(-grid.area * div(layer_v, 1000.0), HOUR_SECONDS)
        act_v = torch.sum(layer_v, dim=0)

        # inter-row grass: shallow trapezoid roots, ET0-driven
        pot_grass = crop_mod.potential_transpiration(
            et0, torch.full_like(dem2d, self.grass_lai),
            self.grass_crop.kc_max)
        sink_g, act_g = self._layer_uptake(
            pot_grass, self.grass_root_density, saw, theta, theta_wp)
        # stomatal stress coefficient 1 - Gs/Gs_nostress
        # (getStressCoefficient, grapevine.cpp:1043-1055)
        self.stress = fluxes["stress_coefficient"]
        out["vine_stress"] = self.stress
        out["vine_transpiration"] = act_v
        out["grass_transpiration"] = act_g

        # ---- evaporation from the bare soil fraction
        surf_water = self.water.surface_water_level(grid)
        sink_e, _ = crop_mod.evaporation_sink(
            grid, params, theta, surf_water, et0, fluxes["lai"])

        # ---- precipitation + irrigation -> surface
        irr_mm = self.hourly_irrigation(hour)
        water_in_mm = prec + irr_mm
        prec_flow = div(grid.area * div(water_in_mm, 1000.0), HOUR_SECONDS)
        sink = sink_v + sink_g + sink_e
        sink[0] += where(valid, prec_flow, 0.0)
        out["irrigation"] = irr_mm

        # ---- hourly downy mildew (computeDiseases; downyMildew.cpp)
        if self.compute_diseases:
            with torch.profiler.record_function(DISEASES_RANGE):
                self.downy, dm_out = downy_mildew_step(
                    self.downy, DownyMildewInput(
                        tair=air_t, rain=prec, leaf_wetness=leaf_wetness,
                        relative_humidity=rh),
                    is_first_january=(month == 1 and day == 1 and hour == 0))
            out["downy_mildew_infection"] = dm_out["is_infection"]

        # ---- daily accumulators: per-cell temperature maps (VINE3D drives
        # phenology from the hourly temperature maps per cell, modelCore.cpp)
        t_map = where(valid, air_t, 0.0)
        self._tsum = self._tsum + t_map
        self._tmin = torch.minimum(as_f64(self._tmin, grid.device), t_map)
        self._tmax = torch.maximum(as_f64(self._tmax, grid.device), t_map)
        self._nhours += 1
        self._rain_mm = self._rain_mm + prec
        self._wet_hours = self._wet_hours + leaf_wetness
        self._rh_sum = self._rh_sum + rh

        # ---- 3D soil water fluxes (shared solver)
        self.water = dataclasses.replace(self.water, sink_source=sink)
        self.water, out["solver_stats"] = compute_period_stats(
            grid, params, self.water, HOUR_SECONDS)
        out["mbr"] = float(host_read(self.water.balance_whole.mbr))
        return out

    # ------------------------------------------------------------------
    def daily_update(self, date: datetime.date) -> dict:
        """End of day: phenology, LAI growth, fruit biomass, powdery
        mildew."""
        p = self.vine_params
        n = max(self._nhours, 1)
        tavg = div(self._tsum, n) if isinstance(self._tsum, torch.Tensor) \
            else self._tsum / n            # (R,C) per-cell daily mean
        # exponential running mean with ~30-day e-folding (Kattge-Knorr
        # acclimation input of the canopy fluxes)
        self._t30_avg = self._t30_avg + div(tavg - self._t30_avg, 30.0)
        doy = date.timetuple().tm_yday

        # thermal-sum bookkeeping before phenology (updateThermalSum,
        # bin/VINE3D/plant.cpp:378-420), then the PhenoVitis step
        after_march = (date.month, date.day) >= (3, 1)
        self.vine = gv.update_thermal_sum(self.vine, tavg, after_march)
        self.vine = gv.phenology_daily_step(self.vine, p, tavg, doy)
        self.vine = gv.lai_vine_daily(
            self.vine, p, tavg, doy,
            stress_coefficient=torch.clamp_min(1.0 - self.stress, 0.0))
        self.vine = gv.fruit_biomass_step(self.vine, p, self._assim_gm2)

        out = dict(tavg=tavg,
                   tavg_mean=masked_mean(tavg, self.grid.mask[0]),
                   stage=self.vine.stage,
                   lai=self.vine.lai,
                   fruit_biomass=self.vine.fruit_biomass,
                   tartaric_acid=gv.tartaric_acid(self.vine))
        if self.compute_diseases:
            with torch.profiler.record_function(DISEASES_RANGE):
                bud_break = bool(host_read(torch.any(
                    (self.vine.stage >= gv.Stage.BUD_BURST)
                    & (self.vine.stage < gv.Stage.BUD_BURST + 0.05))))
                self.powdery, pm_out = powdery_mildew_step(
                    self.powdery, tavg=tavg, rain=self._rain_mm,
                    leaf_wetness=torch.clamp_max(self._wet_hours, 24.0),
                    relative_humidity=div(self._rh_sum, n),
                    is_bud_break=bud_break)
            out["powdery_infection_risk"] = pm_out["infection_risk"]
        # reset the accumulators
        shape2d = tuple(self.grid.shape[1:])
        self._tsum, self._tmin, self._tmax, self._nhours = 0.0, 1e9, -1e9, 0

        def zeros():
            return torch.zeros(shape2d, dtype=torch.float64,
                               device=self.grid.device)

        self._rain_mm = zeros()
        self._wet_hours = zeros()
        self._rh_sum = zeros()
        self._assim_gm2 = zeros()
        return out

    # ------------------------------------------------------------------
    def run_period(self, first_day: datetime.date, n_days: int,
                   forcing_provider) -> list:
        """Multi-day driver (Vine3DProject::runModels / modelDailyCycle):
        ``forcing_provider(date, hour) -> HourlyForcing``."""
        daily_log = []
        for d in range(n_days):
            date = first_day + datetime.timedelta(days=d)
            for hour in range(24):
                forcing = forcing_provider(date, hour)
                out = self.run_hour(forcing, date.year, date.month, date.day,
                                    hour)
            day_out = self.daily_update(date)
            daily_log.append(dict(date=str(date), mbr=out["mbr"],
                                  tavg=day_out["tavg_mean"]))
        return daily_log

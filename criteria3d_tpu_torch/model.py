"""Hourly model orchestration: Crit3DProject::runModelHour in PyTorch.

PyTorch counterpart of ``criteria3d_tpu/model.py``. One simulated hour
(bin/CRITERIA3D/criteria3DProject.cpp:2020-2135):

1. solar radiation on the DEM (clear/real sky, shadowing);
2. snow accumulation / melt (Brooks);
3. reference evapotranspiration (Penman-Monteith hourly);
4. the HYDRALL forest model (``compute_hydrall``);
5. sink/source assembly: canopy interception, soil-cracking preferential
   flow, precipitation/snowmelt, soil evaporation, crop transpiration;
6. the coupled surface-subsurface water step over 3600 s
   (``compute_period_stats``), or the coupled water + heat period
   (``compute_period_coupled``) with ``compute_heat``.

The orchestration is host Python, as the reference's hourly loop is host
C++; every map is a tensor on the grid's device, and the hourly forcing is
moved there first. The catchment accumulators stay 0-d device tensors:
``run_period`` reads them, and the daily MBRs, only at the end; its monthly
RothC forcing (``compute_rothc``) is summed on the device too.
"""

from __future__ import annotations

import dataclasses
import datetime

import torch

from criteria3d_tpu_torch.constants import (HOUR_SECONDS, STEFAN_BOLTZMANN,
                                            ZEROCELSIUS)
from criteria3d_tpu_torch.core.grid import Grid
from criteria3d_tpu_torch.core.soil import theta_from_se
from criteria3d_tpu_torch.core.state import SolverParameters, WaterState
from criteria3d_tpu_torch.device import host_read
from criteria3d_tpu_torch.ops import as_f64, div, ipow, where
from criteria3d_tpu_torch.physics import crop as crop_mod
from criteria3d_tpu_torch.physics import hydrall as hy
from criteria3d_tpu_torch.physics import meteo as meteo_mod
from criteria3d_tpu_torch.physics import radiation as rad_mod
from criteria3d_tpu_torch.physics.cracking import soil_cracking
from criteria3d_tpu_torch.physics.interception import canopy_water_management
from criteria3d_tpu_torch.physics.rothc import RothCState, rothc_monthly_step
from criteria3d_tpu_torch.physics.snow import SnowForcing, SnowState, snow_step
from criteria3d_tpu_torch.solver import heat as H
from criteria3d_tpu_torch.solver import water as W
from criteria3d_tpu_torch.solver.coupled import compute_period_coupled
from criteria3d_tpu_torch.solver.step import (compute_period_stats,
                                              initialize_balance)

__all__ = ["HourlyForcing", "ModelConfig", "Criteria3DModel", "masked_mean",
           "ET0_RANGE"]

# torch.profiler range of the ET0 map (chip_smoke.py reads it; the
# radiation, snow and sink ranges are in their modules)
ET0_RANGE = "c3d.et0"


def masked_mean(x, valid, *, device: bool = False):
    """Catchment mean of ``x`` over the *valid* cells only (the reference
    accumulates over nrValidCells, criteria3DProject.cpp dailyUpdate).

    ``device=True`` returns the 0-d device tensor instead of a host float,
    so an hourly loop can accumulate without a host read."""
    n = torch.clamp_min(torch.sum(valid), 1)
    out = torch.sum(torch.where(valid, x, 0.0)) / n
    return out if device else float(host_read(out))


@dataclasses.dataclass
class HourlyForcing:
    """Hourly meteorological maps, (R, C) or broadcastable to it: numbers,
    numpy arrays or tensors (``run_hour`` moves them to the grid's device
    as float64)."""

    air_temperature: object    # [degC]
    precipitation: object      # [mm/h]
    rel_humidity: object       # [%]
    wind_speed: object         # [m s-1]
    transmissivity: object = 0.75


@dataclasses.dataclass
class ModelConfig:
    """Process toggles (Crit3DProcesses, project3D.h:57-75)."""

    compute_snow: bool = True
    compute_crop: bool = True
    compute_evaporation: bool = True
    compute_cracking: bool = False
    compute_interception: bool = False
    compute_heat: bool = False
    initial_soil_temperature: float = 288.15   # [K]
    compute_hydrall: bool = False
    compute_rothc: bool = False
    latitude: float = 44.5
    longitude: float = 11.3
    timezone: int = 1
    clear_sky_transmissivity: float = 0.75
    linke: float = 3.5
    albedo: float = 0.2


def _on(grid: Grid, v, shape) -> torch.Tensor:
    """A forcing value as a float64 (R, C) tensor on the grid's device."""
    if isinstance(v, torch.Tensor):
        v = v.to(device=grid.device, dtype=torch.float64)
    else:
        v = torch.as_tensor(v, dtype=torch.float64, device=grid.device)
    return torch.broadcast_to(v, shape)


@dataclasses.dataclass
class Criteria3DModel:
    """Holds grid + states and advances them hour by hour."""

    grid: Grid
    params: SolverParameters
    config: ModelConfig
    water: WaterState
    heat: H.HeatState | None = None
    hydrall: hy.HydrallMaps | None = None
    rothc: RothCState | None = None
    # (R,C) forest land-use cells: HYDRALL's NPP and transpiration
    forest_mask: torch.Tensor | None = None
    snow: SnowState | None = None
    crop: crop_mod.CropParameters | None = None
    lai: torch.Tensor | None = None            # (R,C)
    degree_days: torch.Tensor | None = None    # (R,C)
    canopy_storage: torch.Tensor | None = None
    slope_deg: torch.Tensor | None = None
    aspect_deg: torch.Tensor | None = None
    # 0-d device tensors during a run (no per-hour host read); read them
    # with float()
    total_evaporation_mm: object = 0.0
    total_transpiration_mm: object = 0.0
    total_precipitation_m3: object = 0.0
    # the forest litter [kg C m-2] of the Jan-1 HYDRALL steps that feeds
    # RothC: the number 0.0 until the first annual step makes it a map
    _rothc_litter: object = 0.0

    @staticmethod
    def create(grid: Grid, params: SolverParameters, config: ModelConfig,
               *, matric_potential=-2.0,
               crop: crop_mod.CropParameters | None = None) -> "Criteria3DModel":
        """Initial states on the grid's device; slope and aspect are left
        None (flat radiation) until the caller sets them."""
        dev = grid.device
        water = WaterState.initialize(grid, params,
                                      matric_potential=matric_potential,
                                      device=dev)
        water = initialize_balance(grid, params, water)
        shape2d = grid.shape[1:]
        snow = SnowState.zero(shape2d, device=dev) if config.compute_snow else None
        heat = None
        if config.compute_heat:
            heat = H.initialize_heat(grid, config.initial_soil_temperature)
            heat = dataclasses.replace(
                heat,
                storage_prev=H.heat_storage(grid, params, heat, water),
                storage_whole=H.heat_storage(grid, params, heat, water))
        hydrall = (hy.HydrallMaps.initialize(shape2d, device=dev)
                   if config.compute_hydrall else None)
        rothc = (RothCState.initialize(shape2d, device=dev)
                 if config.compute_rothc else None)
        if crop is None and config.compute_crop:
            crop = crop_mod.CropParameters()

        def full(v):
            return torch.full(shape2d, v, dtype=torch.float64, device=dev)

        return Criteria3DModel(
            grid=grid, params=params, config=config, water=water, heat=heat,
            hydrall=hydrall, rothc=rothc, snow=snow, crop=crop,
            lai=full(2.0) if config.compute_crop else None,
            degree_days=full(600.0) if config.compute_crop else None,
            canopy_storage=full(0.0),
        )

    # ------------------------------------------------------------------
    def daily_update(self, t_min, t_max, *, date=None):
        """Daily updates: crop degree days + LAI (dailyUpdateCropMaps,
        criteria3DProject.cpp:1224), the HYDRALL running-mean temperature
        and its Jan-1 annual allocation, whose litter feeds RothC
        (dailyUpdateHydrall, :634-700, 1238). ``t_min``/``t_max`` are
        per-cell (R, C) daily extreme maps; numbers broadcast."""
        shape = self.grid.shape[1:]
        t_min = _on(self.grid, t_min, shape)
        t_max = _on(self.grid, t_max, shape)
        if self.config.compute_crop:
            inc = crop_mod.degree_day_increase(self.crop, t_min, t_max)
            self.degree_days = self.degree_days + inc
            self.lai = crop_mod.lai_from_degree_days(self.crop,
                                                     self.degree_days)
        if self.config.compute_hydrall and self.hydrall is not None:
            self.hydrall = hy.hydrall_daily_update(self.hydrall,
                                                   0.5 * (t_min + t_max))
            if date is not None and date.month == 1 and date.day == 1:
                self.hydrall, litter = hy.hydrall_annual_update(self.hydrall)
                if self.rothc is not None:
                    # annual forest litter feeds the RothC input pools
                    # (updateRothC plant-input path)
                    self._rothc_litter = self._rothc_litter + litter

    def monthly_rothc_update(self, t_avg_month, prec_month_mm,
                             et0_month_mm, *, clay_pct=25.0,
                             plant_cover=0.6):
        """Monthly RothC step (updateRothC, criteria3DProject.cpp:1233-1236)
        with a twelfth of the forest litter as its carbon input; the
        forcing may be numbers or 0-d tensors. Returns the step's
        diagnostics, None without RothC."""
        if self.rothc is None:
            return None
        dev = self.grid.device
        bic = as_f64(prec_month_mm, dev) - 0.75 * as_f64(et0_month_mm, dev)
        monthly_c = div(as_f64(self._rothc_litter, dev), 12.0)
        self.rothc, out = rothc_monthly_step(
            self.rothc, temp_c=t_avg_month, monthly_bic=bic,
            clay_pct=clay_pct, plant_cover=plant_cover,
            carbon_input=monthly_c)
        return out

    # ------------------------------------------------------------------
    def run_hour(self, forcing: HourlyForcing, year: int, month: int, day: int,
                 hour: int) -> dict:
        """One hour of the full model cycle. Returns diagnostics: tensors on
        the grid's device, and for a water-only hour also ``solver_stats``,
        the host ints ``(steps, attempts, approximations, inner
        iterations)`` of ``compute_period_stats`` (the JAX function calls
        ``compute_period`` and returns none)."""
        grid, params, cfg = self.grid, self.params, self.config
        valid = grid.mask[0]
        dem2d = grid.z[0]
        shape = tuple(dem2d.shape)
        air_t = _on(grid, forcing.air_temperature, shape)
        prec = _on(grid, forcing.precipitation, shape)
        rh = _on(grid, forcing.rel_humidity, shape)
        wind = _on(grid, forcing.wind_speed, shape)
        trans = _on(grid, forcing.transmissivity, shape)
        out = {}

        # ---- radiation (interpolateDemRadiation, criteria3DProject.cpp:2050)
        zeros = torch.zeros_like(dem2d)
        slope = self.slope_deg if self.slope_deg is not None else zeros
        aspect = self.aspect_deg if self.aspect_deg is not None else zeros
        rad = rad_mod.compute_radiation_dem(
            dem2d, valid, grid.cell_size,
            torch.full_like(dem2d, cfg.latitude),
            torch.full_like(dem2d, cfg.longitude), slope, aspect,
            cfg.timezone, year, month, day, hour,
            linke=cfg.linke, albedo=cfg.albedo,
            clear_sky_transmissivity=cfg.clear_sky_transmissivity,
            transmissivity=trans)
        out["global_radiation"] = rad.global_irr
        out["shadow"] = rad.shadow

        # ---- snow (computeSnowModel, criteria3DProject.cpp:1761-1860)
        water_input_mm = prec
        if cfg.compute_snow and self.snow is not None:
            surf_water_mm = self.water.surface_water_level(grid) * 1000.0
            sf = SnowForcing(
                air_temp=air_t, precipitation=prec, rel_humidity=rh,
                wind_speed=wind, global_radiation=rad.global_irr,
                beam_radiation=rad.beam, transmissivity=trans,
                clear_sky_transmissivity=torch.full_like(
                    dem2d, cfg.clear_sky_transmissivity),
                surface_water=surf_water_mm)
            self.snow, snow_out = snow_step(self.snow, sf)
            # water input = rain + snowmelt (snow stays on the pack)
            water_input_mm = snow_out["rain"] + torch.clamp_min(
                snow_out["snow_melt"], 0.0)
            out["swe"] = self.snow.swe
            out["snow_melt"] = snow_out["snow_melt"]

        # ---- ET0 (computeET0PMMap, criteria3DProject.cpp:2078)
        with torch.profiler.record_function(ET0_RANGE):
            norm_trans = div(trans, cfg.clear_sky_transmissivity)
            et0 = meteo_mod.et0_penman_hourly(dem2d, norm_trans, rad.global_irr,
                                              air_t, rh, wind)
            et0 = where(valid, et0, 0.0)
        out["et0"] = et0

        # ---- HYDRALL forest model (computeHydrallModel,
        # criteria3DProject.cpp:886-888, 1827-1915)
        if cfg.compute_hydrall and self.hydrall is not None:
            t_air_k = air_t + ZEROCELSIUS
            ea_h = div(meteo_mod.saturation_vapor_pressure(air_t) * rh, 100.0)
            lw = meteo_mod.atmospheric_emissivity_brutsaert(ea_h, t_air_k) \
                * STEFAN_BOLTZMANN * ipow(t_air_k, 4)
            self.hydrall, hyd_out = hy.hydrall_hour(
                self.hydrall, air_temp_c=air_t, rel_humidity=rh,
                beam_irr=rad.beam, diffuse_irr=rad.diffuse, longwave_irr=lw,
                sun_elevation_deg=rad.sun["elevation_refr"],
                pressure_pa=meteo_mod.pressure_from_altitude(dem2d),
                prec_mm=prec, et0_mm=et0, year=year,
                doy=rad_mod._day_of_year(year, month, day),
                forest_mask=self.forest_mask)
            out["hydrall_assimilation"] = hyd_out["assimilation"]
            out["hydrall_transpiration"] = hyd_out["transpiration_mm"]

        with torch.profiler.record_function(crop_mod.SINKS_RANGE):
            sink = self._sinks(water_input_mm, et0, out)

        # ---- heat boundary + HeatSurface evaporative water flux
        # (computeStep heat interleaving, soilFluxes3D.cpp:1800-1818;
        # HeatSurface water BC, water.cpp:708-747)
        boundary = None
        if cfg.compute_heat and self.heat is not None:
            t_air_k = air_t + ZEROCELSIUS
            # net irradiance: absorbed shortwave + incoming longwave
            # (Brutsaert clear-sky emissivity) - surface emission
            es = meteo_mod.saturation_vapor_pressure(air_t)
            ea = div(es * rh, 100.0)
            eps_atm = meteo_mod.atmospheric_emissivity_brutsaert(ea, t_air_k)
            t_surf = self.heat.t[1]
            net_irr = (1.0 - cfg.albedo) * rad.global_irr \
                + eps_atm * STEFAN_BOLTZMANN * ipow(t_air_k, 4) \
                - 0.97 * STEFAN_BOLTZMANN * ipow(t_surf, 4)
            boundary = H.HeatBoundary(
                mask=grid.mask[0], air_temperature=t_air_k,
                rel_humidity=rh, wind_speed=torch.clamp_min(wind, 0.01),
                net_irradiance=net_irr,
                height_wind=torch.full_like(t_air_k, 10.0),
                height_temperature=torch.full_like(t_air_k, 2.0),
                roughness_height=torch.full_like(t_air_k, 0.01))
            if params.heat_vapor:
                # the evaporative water sink is applied per Picard
                # iteration inside the coupled stepper (boundary_flux_fn,
                # water.cpp:708-747); this hour-start evaluation is only a
                # diagnostic estimate
                evap_sink = H.heat_surface_water_sink(
                    grid, params, self.heat, boundary, self.water,
                    HOUR_SECONDS)
                out["heat_surface_evaporation_m3s"] = torch.sum(evap_sink)

        # ---- water fluxes (runWaterFluxes3DModel, project3D.cpp:1304-1386)
        self.water = dataclasses.replace(self.water, sink_source=sink)
        params = self._resolve_precond(params, sink)
        if boundary is not None:
            self.water, self.heat = compute_period_coupled(
                grid, params, self.water, self.heat, boundary, HOUR_SECONDS)
            out["soil_temperature"] = self.heat.t
        else:
            self.water, out["solver_stats"] = compute_period_stats(
                grid, params, self.water, HOUR_SECONDS)

        out["mbr"] = self.water.balance_whole.mbr
        out["courant"] = self.water.courant
        return out

    def _sinks(self, water_input_mm, et0, out: dict) -> torch.Tensor:
        """Interception, cracking, precipitation, evaporation and
        transpiration into the (L, R, C) sink [m3 s-1]
        (criteria3DProject.cpp:2094-2106); updates the canopy storage and
        the accumulators."""
        grid, params, cfg = self.grid, self.params, self.config
        valid = grid.mask[0]

        # ---- canopy interception
        if cfg.compute_interception and self.lai is not None:
            canopy = canopy_water_management(
                self.canopy_storage, water_input_mm, et0, self.lai)
            self.canopy_storage = canopy["stored_water"]
            water_input_mm = canopy["soil_water"]

        sink = torch.zeros(grid.shape, dtype=params.dtype, device=grid.device)
        se = W.compute_se(grid, params, self.water.h)
        theta = where(grid.mask, theta_from_se(grid.soil, se), 0.0)

        # cracking diverts part of the rain directly into dry soil layers
        if cfg.compute_cracking:
            crack_sink, water_input_mm = soil_cracking(
                grid, params, se, water_input_mm, self.water.pond * 1000.0)
            sink = sink + crack_sink

        # precipitation -> surface nodes
        prec_flow = div(grid.area * div(water_input_mm, 1000.0), HOUR_SECONDS)
        prec_flow = where(valid, prec_flow, 0.0)
        sink[0] += prec_flow
        self.total_precipitation_m3 = self.total_precipitation_m3 \
            + torch.sum(prec_flow) * HOUR_SECONDS

        # evaporation
        if cfg.compute_evaporation:
            lai = self.lai if self.lai is not None else torch.zeros_like(et0)
            surf_water = self.water.surface_water_level(grid)
            evap_sink, evap_mm = crop_mod.evaporation_sink(
                grid, params, theta, surf_water, et0, lai)
            sink = sink + evap_sink
            self.total_evaporation_mm = self.total_evaporation_mm \
                + masked_mean(evap_mm, valid, device=True)
            out["evaporation"] = evap_mm

        # transpiration
        if cfg.compute_crop and self.crop is not None:
            tr_sink, tr_mm = crop_mod.transpiration_sink(
                grid, params, self.crop, theta, et0, self.lai,
                self.degree_days)
            sink = sink + tr_sink
            self.total_transpiration_mm = self.total_transpiration_mm \
                + masked_mean(tr_mm, valid, device=True)
            out["transpiration"] = tr_mm
        return sink

    # ------------------------------------------------------------------
    def _resolve_precond(self, params: SolverParameters, sink):
        """Resolve ``cg_precond="auto"``: the JAX package resolves it to
        "line" unconditionally (its measured best in both regimes)."""
        if params.cg_precond != "auto":
            return params
        return dataclasses.replace(params, cg_precond="line")

    # ------------------------------------------------------------------
    def run_period(self, first_day, n_days: int, forcing_provider,
                   *, state_save_dir: str | None = None,
                   save_daily_state: bool = False) -> list:
        """Multi-day driver (Crit3DProject::runModels,
        criteria3DProject.cpp:1169-1318): per day, 24 hourly cycles with the
        daily update at hour 23, the monthly RothC step at a month's last
        day and optional state checkpoints.

        ``forcing_provider(date, hour) -> HourlyForcing``; ``first_day`` is
        a ``datetime.date``. Returns ``[{"date": ..., "mbr": float}, ...]``,
        the MBRs read from the device at the end of the period. With RothC
        the month's mean air temperature, precipitation and ET0 are summed
        hour by hour as 0-d device tensors."""
        from criteria3d_tpu_torch.io.state_io import save_state, state_dir_name

        grid = self.grid
        valid = grid.mask[0]
        shape = grid.shape[1:]
        daily_log = []
        month_acc = dict(t=0.0, prec=0.0, et0=0.0, n=0)
        for d in range(n_days):
            date = first_day + datetime.timedelta(days=d)
            t_min, t_max = None, None
            for hour in range(24):
                forcing = forcing_provider(date, hour)
                # per-cell daily Tmin/Tmax maps (criteria3DProject.cpp:1224)
                t_map = where(grid.mask[0], _on(grid, forcing.air_temperature,
                                                shape), 0.0)
                t_min = t_map if t_min is None else torch.minimum(t_min, t_map)
                t_max = t_map if t_max is None else torch.maximum(t_max, t_map)
                out = self.run_hour(forcing, date.year, date.month, date.day,
                                    hour)
                if self.rothc is not None:
                    month_acc["t"] += masked_mean(
                        _on(grid, forcing.air_temperature, shape), valid,
                        device=True)
                    month_acc["prec"] += masked_mean(
                        _on(grid, forcing.precipitation, shape), valid,
                        device=True)
                    month_acc["et0"] += masked_mean(out["et0"], valid,
                                                    device=True)
                    month_acc["n"] += 1
                # daily update at 23h (criteria3DProject.cpp:1224, 1238)
                if hour == 23:
                    self.daily_update(t_min, t_max, date=date)
            daily_log.append(dict(date=str(date), mbr=out["mbr"]))

            # monthly RothC step at month end (updateRothC, :1233-1236)
            next_day = date + datetime.timedelta(days=1)
            if self.rothc is not None and next_day.month != date.month \
                    and month_acc["n"] > 0:
                self.monthly_rothc_update(
                    div(month_acc["t"], month_acc["n"]), month_acc["prec"],
                    month_acc["et0"])
                month_acc = dict(t=0.0, prec=0.0, et0=0.0, n=0)

            if save_daily_state and state_save_dir:
                path = f"{state_save_dir}/{state_dir_name(date.year, date.month, date.day, 23)}"
                save_state(path, grid, self.water, snow=self.snow,
                           degree_days=self.degree_days, lai=self.lai)
        for e in daily_log:
            e["mbr"] = host_read(e["mbr"])
        return daily_log

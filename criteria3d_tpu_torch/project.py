"""Full-project orchestration: load and run a CRITERIA3D project.

PyTorch counterpart of ``criteria3d_tpu/project.py``, the reference's
Project / Project3D / Crit3DProject load-and-run stack:

* :meth:`Criteria3DProject.load` — ``loadCriteria3DProject``: project ini +
  parameters.ini, DEM, soil map + soil DB, land-use map + land units DB,
  meteo-points DB, output points. Host work: files into numpy arrays and
  station series.
* :meth:`Criteria3DProject.initialize` — ``initialize3DModel``
  (src/project3D/project3D.cpp:456-616): the soil fields per node from the
  horizon lookup, land units, the grid and the model state, built on the
  CUDA card unless ``device`` names another device.
* :meth:`Criteria3DProject.hourly_forcing` — ``interpolateAndSaveHourlyMeteo``
  (criteria3DProject.cpp:2032-2050): gross + spatial QC, elevation-detrended
  IDW of T / precipitation / RH (via dew point) / wind onto the grid's
  device, station transmissivity from observed radiation.
* :meth:`Criteria3DProject.run_hour` / :meth:`run_period` — ``runModelHour``
  / ``runModels`` (criteria3DProject.cpp:1169-1318, 2020-2135): the hourly
  cycle with output rasters (queued on the native C++ writer pool,
  ``native.AsyncRasterWriter``) and output-point series written from the
  loop;
* :meth:`Criteria3DProject.load_meteo_grid` /
  :meth:`export_hourly_to_grid` — a meteo grid DB (``io/meteogrid.py``)
  as the weather source, its active cells as virtual stations, and a map
  aggregated back into its hourly tables;
* :meth:`Criteria3DProject.write_report` — the standalone HTML run report
  (``viz/``).

Station work (QC, regressions) stays on the host, the maps on the device;
each hour reads the card for the stations' clear-sky potential, the output
points' values and the previous hour's staged rasters (all counted by
``device.host_read``). The water-table subsystem (wells, per-well fits
against the nearest station, the daily depth map), the meteo grid DB and
the report's rendering are host numpy and sqlite3.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch

from criteria3d_tpu_torch.constants import NODATA
from criteria3d_tpu_torch.core.geo import latlon_to_utm
from criteria3d_tpu_torch.core.grid import (BoundaryType, Grid,
                                            build_soil_layers, slope_aspect)
from criteria3d_tpu_torch.core.meteo import (QUALITY_RANGES, ClimateParameters,
                                             MeteoStation, MeteoVariable,
                                             check_fast_value_hourly)
from criteria3d_tpu_torch.core.soil import SoilFields, power, theta_from_se
from criteria3d_tpu_torch.core.state import SolverParameters
from criteria3d_tpu_torch.device import host_array, host_read, resolve_device
from criteria3d_tpu_torch.io.config import ProjectConfig, load_project_ini
from criteria3d_tpu_torch.io.database import (SoilProfile, read_crop_db,
                                              read_land_units, read_soil_db)
from criteria3d_tpu_torch.io.esri import (RasterHeader, read_raster,
                                          resample_grid)
from criteria3d_tpu_torch.io.meteopoints import MeteoPointsDB
from criteria3d_tpu_torch.model import (Criteria3DModel, HourlyForcing,
                                        ModelConfig)
from criteria3d_tpu_torch.ops import rdiv, where
from criteria3d_tpu_torch.outputs import (OUTPUTS_RANGE, OutputPoints,
                                          OutputVariable,
                                          compute_output_rasters,
                                          flush_staged_rasters)
from criteria3d_tpu_torch.physics import meteo as meteo_mod
from criteria3d_tpu_torch.physics import radiation as rad_mod
from criteria3d_tpu_torch.physics.interpolation import (
    VariableKind, detrended_idw, regression_orography_t,
    spatial_quality_control)
from criteria3d_tpu_torch.physics.watertable import (WaterTableModel,
                                                     load_well_depths_csv,
                                                     load_well_locations_csv)

__all__ = ["Criteria3DProject", "INTERPOLATION_RANGE", "state_maps"]

# torch.profiler range of the hourly forcing maps: station QC, the
# regressions and the IDW maps (chip_smoke.py reads it)
INTERPOLATION_RANGE = "c3d.interpolation"

# map meteo variables to interpolation post-processing kinds
_VAR_KIND = {
    MeteoVariable.AIR_TEMPERATURE: VariableKind.TEMPERATURE,
    MeteoVariable.AIR_DEW_TEMPERATURE: VariableKind.TEMPERATURE,
    MeteoVariable.PRECIPITATION: VariableKind.PRECIPITATION,
    MeteoVariable.AIR_REL_HUMIDITY: VariableKind.RELATIVE_HUMIDITY,
    MeteoVariable.WIND_SCALAR_INTENSITY: VariableKind.NON_NEGATIVE,
    MeteoVariable.GLOBAL_IRRADIANCE: VariableKind.NON_NEGATIVE,
}

_MIN_STATIONS_FOR_SPATIAL_QC = 5


def state_maps(grid: Grid, params: SolverParameters, water) -> tuple:
    """(root-zone water content [m3 m-3], ponding [mm]) host maps of a
    water state, NODATA off the catchment: the mean theta over the
    subsurface layers and the surface water level, as the JAX report and
    shell compute them. Three counted reads of the grid's device."""
    from criteria3d_tpu_torch.solver import water as W
    theta = theta_from_se(grid.soil, W.compute_se(grid, params, water.h))
    mask = host_array(grid.mask).astype(bool)
    m = mask[1:]
    th = host_array(theta[1:])
    swc = np.where(m.any(0), (th * m).sum(0) / np.maximum(m.sum(0), 1), NODATA)
    pond = np.where(mask[0], host_array(water.surface_water_level(grid)) * 1000.0,
                    NODATA)
    return swc, pond


@dataclasses.dataclass
class Criteria3DProject:
    """A loaded project, ready to initialise and run."""

    config: ProjectConfig
    dem: np.ndarray
    header: RasterHeader
    soils: dict[str, SoilProfile] = dataclasses.field(default_factory=dict)
    soil_id_map: np.ndarray | None = None          # (R,C) id_soil on the DEM
    land_unit_map: np.ndarray | None = None        # (R,C) id_unit on the DEM
    land_units: list = dataclasses.field(default_factory=list)
    crops: dict = dataclasses.field(default_factory=dict)
    stations: list[MeteoStation] = dataclasses.field(default_factory=list)
    # water-table wells + fitted models (project.h:169 waterTableList)
    wells: list = dataclasses.field(default_factory=list)
    watertables: list = dataclasses.field(default_factory=list)
    climate: ClimateParameters | None = None
    output_points: OutputPoints | None = None
    output_dir: str = ""
    warnings: list = dataclasses.field(default_factory=list)
    # the meteo grid DB (load_meteo_grid) and its CellsProperties rows
    meteo_grid: object | None = None
    meteo_grid_cells: list = dataclasses.field(default_factory=list)
    # built by initialize()
    device: torch.device | None = None
    grid: Grid | None = None
    params: SolverParameters | None = None
    model: Criteria3DModel | None = None
    slope_deg: np.ndarray | None = None
    # stations spatial QC has turned away so far, one per (variable, hour)
    qc_rejected: int = 0
    # per-station last good transmissivity (persists across night hours)
    _station_trans: dict = dataclasses.field(default_factory=dict)
    _grid_xy: tuple | None = None
    _grid_z: torch.Tensor | None = None
    # previous hour's output maps, still on the device: copied to the host
    # only after the NEXT hour's work is queued
    _staged_rasters: list | None = None
    # the native C++ writer pool the output rasters are queued on
    _raster_writer: object | None = None

    # ------------------------------------------------------------------
    @classmethod
    def load(cls, ini_path: str, *, meteo_db_path: str | None = None,
             output_dir: str | None = None,
             hourly_window: tuple | None = None) -> "Criteria3DProject":
        """Load a <project>.ini and every data source it references
        (loadCriteria3DProject). Missing optional sources degrade gracefully
        with a warning list in ``self.warnings``. Host work only.

        ``meteo_db_path`` overrides the ini's meteo_points DB;
        ``hourly_window`` ``(t0, t1)`` clips the station series load.
        """
        config = load_project_ini(ini_path)
        dem, header = read_raster(config.dem_path)
        prj = cls(config=config, dem=dem, header=header)

        # --- soil map + DB (loadSoilMap project3D.cpp:681-706 + soilDbTools)
        if config.soil_db_path and os.path.exists(config.soil_db_path):
            prj.soils = read_soil_db(config.soil_db_path)
        else:
            prj.warnings.append("missing soil DB")
        if config.soil_map_path and os.path.exists(
                _with_raster_ext(config.soil_map_path)):
            smap, shdr = read_raster(config.soil_map_path)
            prj.soil_id_map = resample_grid(smap, shdr, header, "prevailing")
        else:
            prj.warnings.append("missing soil map")

        # --- land use map + units (loadLandUseMap project3D.cpp:655-679)
        if config.landuse_map_path and os.path.exists(
                _with_raster_ext(config.landuse_map_path)):
            lmap, lhdr = read_raster(config.landuse_map_path)
            prj.land_unit_map = resample_grid(lmap, lhdr, header,
                                              "prevailing")
        if config.crop_db_path and os.path.exists(config.crop_db_path):
            prj.land_units = read_land_units(config.crop_db_path)
            try:
                prj.crops = read_crop_db(config.crop_db_path)
            except Exception:
                prj.crops = {}

        # --- meteo points DB (loadMeteoPointsDB)
        db_path = meteo_db_path or config.meteo_points_path
        if db_path and os.path.exists(db_path):
            t0, t1 = hourly_window if hourly_window else (None, None)
            with MeteoPointsDB(db_path) as db:
                prj.stations = db.read_stations(load_hourly=True,
                                                t0=t0, t1=t1)
            for st in prj.stations:
                # stations may carry lat/lon only: derive UTM
                if st.utm_x == NODATA or st.utm_y == NODATA or \
                        (st.utm_x == 0 and st.utm_y == 0):
                    x, y, _ = latlon_to_utm(st.latitude, st.longitude,
                                            config.utm_zone)
                    st.utm_x, st.utm_y = float(x), float(y)
        else:
            prj.warnings.append("missing meteo points DB")

        prj.climate = ClimateParameters.from_ini_dict(config.climate_monthly)

        prj.output_dir = output_dir or os.path.join(config.path, "OUTPUT")
        if output_dir:
            # an explicit output dir overrides the ini's output_db location
            name = os.path.basename(config.output_db_path) or "output.db"
            config.output_db_path = os.path.join(output_dir, name)
        return prj

    # ------------------------------------------------------------------
    def initialize(self, *, dtype=torch.float64, fast: bool = False,
                   device=None) -> None:
        """Build the 3-D grid + model state (initialize3DModel,
        project3D.cpp:456-616) on ``device``: None means the CUDA card,
        and raises where there is none.

        ``fast=True`` selects the float32 psi-carry production path with
        CG and the line preconditioner (and, when the project computes
        heat, the chunk-frozen heat properties), as the JAX project does;
        the accuracy-derived dt/MBR acceptance gates are unchanged."""
        dev = resolve_device(device)
        cfg = self.config
        R, C = self.dem.shape
        dem_valid = ~np.isclose(self.dem, self.header.nodata)
        dem = np.where(dem_valid, self.dem, NODATA)

        # --- computation depth (project3D.cpp:497-516)
        if cfg.compute_all_soil_depth and self.soils:
            comp_depth = max(s.total_depth for s in self.soils.values())
        else:
            comp_depth = cfg.imposed_computation_depth
        comp_depth = max(comp_depth, 0.1)

        depths, thicknesses = build_soil_layers(comp_depth)
        L = len(depths)

        # --- soil-index resolution: map id_soil -> profile
        by_id = {s.id_soil: s for s in self.soils.values()}
        soil_codes = np.full((R, C), -1, dtype=int)
        if self.soil_id_map is not None and by_id:
            sm = np.asarray(self.soil_id_map)
            for id_soil in by_id:
                soil_codes[np.isclose(sm, id_soil)] = id_soil
        elif by_id:
            soil_codes[dem_valid] = next(iter(by_id))

        # DEM cells without a soil profile carry no nodes at all
        # (setSoilIndexMap skips them, project3D.cpp:736-742)
        has_soil = soil_codes >= 0
        if by_id:
            dem = np.where(has_soil, dem, NODATA)
            dem_valid &= has_soil

        # --- per-node soil materialisation (setCrit3DNodeSoil,
        #     project3D.cpp:1164-1239): horizon lookup per (soil, layer)
        fields = {k: np.full((L, R, C), np.nan) for k in
                  ("vg_alpha", "vg_n", "vg_he", "theta_s", "theta_r",
                   "k_sat", "mualem_l")}
        soil_depth_map = np.zeros((R, C))
        for id_soil, profile in by_id.items():
            cells = soil_codes == id_soil
            if not cells.any():
                continue
            soil_depth_map[cells] = min(profile.total_depth, comp_depth)
            for l in range(1, L):
                h = profile.horizon_at(min(depths[l],
                                           profile.total_depth - 1e-9))
                if h is None:
                    continue
                for k, v in (("vg_alpha", h.vg_alpha), ("vg_n", h.vg_n),
                             ("vg_he", h.vg_he), ("theta_s", h.theta_s),
                             ("theta_r", h.theta_r), ("k_sat", h.k_sat),
                             ("mualem_l", h.mualem_l)):
                    if v is not None and v != NODATA:
                        fields[k][l][cells] = v
        if not by_id:
            # no soil DB: fall back to a uniform loam (keeps DEM-only
            # projects runnable)
            soil_depth_map[:] = comp_depth
            defaults = dict(vg_alpha=1.0, vg_n=1.4, vg_he=0.02, theta_s=0.43,
                            theta_r=0.05, k_sat=1e-5, mualem_l=0.5)
            for k, v in defaults.items():
                fields[k][:] = v

        # missing horizon parameters inherit from the layer above (a horizon
        # with no texture-class match keeps the profile continuous), then
        # any still-unset nodes get benign values (they are masked out)
        for k in fields:
            for l in range(2, L):
                gap = np.isnan(fields[k][l])
                fields[k][l][gap] = fields[k][l - 1][gap]
        fill = dict(vg_alpha=1.0, vg_n=1.4, vg_he=0.0, theta_s=0.43,
                    theta_r=0.05, k_sat=1e-6, mualem_l=0.5)
        for k in fields:
            fields[k] = np.where(np.isnan(fields[k]), fill[k], fields[k])

        # vg_m and vg_sc in numpy, the Mualem denominator in tensors, as
        # the JAX project computes them
        m = 1.0 - 1.0 / fields["vg_n"]
        sc = (1.0 + (fields["vg_alpha"] * fields["vg_he"])
              ** fields["vg_n"]) ** (-m)

        def t(a):
            return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

        m_arr, sc_arr = t(m), t(sc)
        soil = SoilFields(
            vg_alpha=t(fields["vg_alpha"]), vg_n=t(fields["vg_n"]),
            vg_m=m_arr, vg_he=t(fields["vg_he"]), vg_sc=sc_arr,
            theta_s=t(fields["theta_s"]), theta_r=t(fields["theta_r"]),
            k_sat=t(fields["k_sat"]), mualem_l=t(fields["mualem_l"]),
            mualem_den=1.0 - power(1.0 - power(sc_arr, rdiv(1.0, m_arr)),
                                   m_arr))

        # --- land units -> roughness / pond / Urban / Road
        roughness = np.full((R, C), 0.05)
        pond = np.full((R, C), 0.002)
        land_use = np.zeros((R, C), dtype=np.int8)
        forest_mask = np.zeros((R, C), dtype=bool)
        if self.land_unit_map is not None and self.land_units:
            lm = np.asarray(self.land_unit_map)
            for unit in self.land_units:
                cells = np.isclose(lm, unit["id_unit"])
                if not cells.any():
                    continue
                roughness[cells] = unit["roughness"]
                pond[cells] = unit["pond"]
                lu = str(unit.get("landuse", "")).upper()
                if lu == "URBAN":
                    land_use[cells] = BoundaryType.URBAN
                elif lu == "ROAD":
                    land_use[cells] = BoundaryType.ROAD
                elif lu == "FOREST":
                    forest_mask[cells] = True

        self.device = dev
        self.grid = Grid.build(
            dem, self.header.cellsize, soil,
            total_depth=comp_depth,
            soil_depth_map=soil_depth_map,
            roughness=roughness, pond_max=pond,
            land_use=land_use if self.land_units else None,
            free_catchment_runoff=cfg.free_catchment_runoff,
            free_bottom_drainage=cfg.free_bottom_drainage,
            free_lateral_drainage=cfg.free_lateral_drainage,
            dtype=dtype, device=dev)
        self.params = cfg.solver_parameters(self.header.cellsize)
        if fast:
            # float32 cannot resolve the accuracy rule's 1e-10 residual; the
            # sweep loop clamps its tolerance to 1e-7 (solver/step.py)
            self.params = dataclasses.replace(
                self.params, sweep_dtype=torch.float32, inner_solver="cg",
                cg_precond="line", heat_frozen_props=cfg.compute_heat)

        mconfig = ModelConfig(
            latitude=cfg.latitude, longitude=cfg.longitude,
            timezone=cfg.time_zone if not cfg.is_utc else 0,
            clear_sky_transmissivity=cfg.clear_sky_transmissivity,
            linke=cfg.linke, albedo=cfg.albedo,
            compute_heat=cfg.compute_heat)
        psi0 = cfg.initial_water_potential \
            if cfg.is_initial_water_potential else -3.0
        self.model = Criteria3DModel.create(self.grid, self.params, mconfig,
                                            matric_potential=psi0)
        if forest_mask.any():
            self.model.forest_mask = torch.tensor(forest_mask & dem_valid,
                                                  device=dev)
        slope, aspect = slope_aspect(dem, self.header.cellsize)
        self.model.slope_deg = torch.tensor(np.where(dem_valid, slope, 0.0),
                                            device=dev)
        self.model.aspect_deg = torch.tensor(np.where(dem_valid, aspect, 0.0),
                                             device=dev)
        self.slope_deg = slope

        # --- output points (agrolib/outputPoints CSV list)
        if cfg.output_points_path and os.path.exists(cfg.output_points_path):
            self.output_points = self._load_output_points(
                cfg.output_points_path)

        # grid coordinate and elevation maps for interpolation
        rows, cols = np.mgrid[0:R, 0:C]
        gx = self.header.xllcorner + (cols + 0.5) * self.header.cellsize
        gy = self.header.yllcorner + (R - rows - 0.5) * self.header.cellsize
        self._grid_xy = (torch.tensor(gx, device=dev), torch.tensor(gy, device=dev))
        self._grid_z = torch.tensor(
            np.where(np.isclose(self.dem, self.header.nodata), 0.0, self.dem),
            dtype=torch.float64, device=dev)

    def _load_output_points(self, path: str) -> OutputPoints:
        """CSV with id, latitude, longitude columns -> grid rows/cols."""
        import csv
        ids, rows, cols = [], [], []
        R, C = self.dem.shape
        with open(path) as f:
            for rec in csv.DictReader(f):
                if "utm_x" in rec and "utm_y" in rec:
                    x, y = float(rec["utm_x"]), float(rec["utm_y"])
                else:
                    x, y, _ = latlon_to_utm(float(rec["latitude"]),
                                            float(rec["longitude"]),
                                            self.config.utm_zone)
                col = int((x - self.header.xllcorner) / self.header.cellsize)
                row = R - 1 - int((y - self.header.yllcorner)
                                  / self.header.cellsize)
                if 0 <= row < R and 0 <= col < C:
                    ids.append(rec.get("id", str(len(ids))))
                    rows.append(row)
                    cols.append(col)
        return OutputPoints(ids, rows, cols)

    # ------------------------------------------------------------------
    # the meteo grid DB as a weather source
    # ------------------------------------------------------------------
    def load_meteo_grid(self, xml_path: str, db_path: str, *,
                        as_forcing: bool = True, var_map: dict | None = None
                        ) -> None:
        """Attach an XML-described meteo grid DB as a weather source.

        Reference: Project::loadMeteoGridDB + the per-row data-load loop
        (project.cpp:1699-1770) and meteoGrid fillMeteoPoint: grid cells
        are modelled as meteo points, so with ``as_forcing`` every ACTIVE
        cell becomes a virtual station (centre coordinates, CellsProperties
        height, hourly series from the per-cell tables) and the whole
        QC / detrending / interpolation pipeline drives from the grid
        unchanged. Host work only."""
        from criteria3d_tpu_torch.io.meteogrid import (MeteoGridDb,
                                                       parse_grid_xml,
                                                       stations_from_grid)
        structure = parse_grid_xml(xml_path)
        self.meteo_grid = MeteoGridDb(db_path, structure)
        self.meteo_grid_cells = self.meteo_grid.load_cell_properties()
        if as_forcing:
            self.stations = stations_from_grid(
                self.meteo_grid, self.meteo_grid_cells, var_map=var_map,
                utm_zone=self.config.utm_zone)
            if not self.stations:
                self.warnings.append("meteo grid has no active cells")

    def export_hourly_to_grid(self, varcode: int, map2d,
                              when: datetime.datetime, *,
                              method: str = "average") -> np.ndarray:
        """Aggregate a DEM-resolution map onto the meteo grid and write it
        into the per-cell hourly tables (Crit3DMeteoGrid::
        spatialAggregateMeteoGrid, meteoGrid.cpp:139, then the hourly DB
        save); returns the aggregated (nr_rows, nr_cols) array. A map on
        the device comes to the host in one counted copy."""
        from criteria3d_tpu_torch.io.meteogrid import aggregate_raster_to_grid
        if self.meteo_grid is None:
            raise ValueError("no meteo grid loaded (load_meteo_grid first)")
        values = (host_array(map2d) if isinstance(map2d, torch.Tensor)
                  else np.asarray(map2d))
        agg = aggregate_raster_to_grid(values, self.header,
                                       self.meteo_grid.structure, method=method)
        self.meteo_grid.write_hourly_map(self.meteo_grid_cells, varcode,
                                         when, agg)
        return agg

    # --- water table subsystem (Project::waterTableImportLocation /
    #     waterTableImportDepths / waterTableComputeSingleWell,
    #     project.cpp:5952-6120; project.h:169,359-361) ----------------

    def watertable_import_location(self, csv_path: str) -> int:
        """Load well locations; returns the wrong-line count."""
        self.wells, wrong = load_well_locations_csv(
            csv_path, utm_zone=self.config.utm_zone)
        if wrong:
            self.warnings.append(f"well locations: {wrong} wrong lines")
        return wrong

    def watertable_import_depths(self, csv_path: str,
                                 max_depth_cm: float = 300.0) -> int:
        """Load per-well depth observations; returns the wrong-line count."""
        wrong = load_well_depths_csv(csv_path, self.wells,
                                     max_depth_cm=max_depth_cm)
        if wrong:
            self.warnings.append(f"well depths: {wrong} wrong lines")
        return wrong

    @staticmethod
    def _station_daily_et0(well, st):
        """(prec, et0, n): the station's daily precipitation and its daily
        Hargreaves ET0 at the well's latitude (the station's when the well
        has none), as WaterTable::setMeteoData (waterTable.cpp:84-97)
        takes them; host arrays, ET0 computed on the CPU."""
        tmin = np.asarray(st.daily[MeteoVariable.DAILY_TMIN], float)
        tmax = np.asarray(st.daily[MeteoVariable.DAILY_TMAX], float)
        prec = np.asarray(st.daily[MeteoVariable.DAILY_PREC], float)
        n = min(len(tmin), len(tmax), len(prec))
        doy = np.array([
            (st.daily_d0 + datetime.timedelta(days=int(i))).timetuple()
            .tm_yday for i in range(n)])
        lat = well.latitude if well.latitude != NODATA else st.latitude
        et0 = meteo_mod.et0_hargreaves_daily(
            0.17, torch.tensor(lat, dtype=torch.float64), doy,
            torch.from_numpy(tmax[:n].copy()),
            torch.from_numpy(tmin[:n].copy())).numpy()
        return prec, et0, n, tmin, tmax

    def watertable_compute(self, step_days: int = 5) -> list:
        """Fit one CWB-correlation model per well against the nearest
        station's daily series (waterTableComputeSingleWell +
        waterTableAssignNearestMeteoPoint, project.cpp:5997-6120: prec
        observed, ET0 by daily Hargreaves from Tmin/Tmax). Fills
        ``self.watertables`` with (well, model, station) triples for every
        well whose fit succeeds."""
        MV = MeteoVariable
        self.watertables = []
        daily_ok = [st for st in self.stations
                    if st.daily_d0 is not None
                    and MV.DAILY_TMIN in st.daily and MV.DAILY_TMAX in st.daily
                    and MV.DAILY_PREC in st.daily]
        if not daily_ok:
            self.warnings.append("watertable: no station with daily series")
            return []
        for well in self.wells:
            if not well.depths:
                continue
            st = min(daily_ok, key=lambda s: (s.utm_x - well.utm_x) ** 2
                     + (s.utm_y - well.utm_y) ** 2)
            prec, et0, n, tmin, tmax = self._station_daily_et0(well, st)
            bad = (tmin[:n] == NODATA) | (tmax[:n] == NODATA)
            et0 = np.where(bad, NODATA, et0)

            obs_idx, obs_depth = [], []
            for date, depth in sorted(well.depths.items()):
                i = (date - st.daily_d0).days
                if 0 <= i < n:
                    obs_idx.append(i)
                    obs_depth.append(depth)
            model = WaterTableModel()
            if obs_idx and model.fit(prec[:n], et0, np.asarray(obs_idx),
                                     np.asarray(obs_depth),
                                     step_days=step_days):
                self.watertables.append((well, model, st))
            else:
                self.warnings.append(f"watertable: fit failed for well "
                                     f"{well.id}")
        return self.watertables

    def watertable_depth_map(self, day: datetime.date) -> np.ndarray | None:
        """(R, C) water-table depth [m] map for one day: per-well model
        estimates spread by inverse-distance weighting over the DEM, a host
        array (the grid coordinates are read from the device once)."""
        if not self.watertables:
            return None
        xs, ys, ds = [], [], []
        for well, model, st in self.watertables:
            i = (day - st.daily_d0).days
            prec, et0, n, _, _ = self._station_daily_et0(well, st)
            d = model.depth(prec[:n], et0, i)
            if d != NODATA:
                xs.append(well.utm_x)
                ys.append(well.utm_y)
                ds.append(d * 0.01)           # [cm] -> [m]
        if not ds:
            return None
        gx, gy = self._grid_xy
        gx = (host_array(gx) if isinstance(gx, torch.Tensor)
              else np.asarray(gx))[None]
        gy = (host_array(gy) if isinstance(gy, torch.Tensor)
              else np.asarray(gy))[None]
        xs = np.asarray(xs)[:, None, None]
        ys = np.asarray(ys)[:, None, None]
        w = 1.0 / np.maximum((gx - xs) ** 2 + (gy - ys) ** 2, 1.0)
        out = (np.asarray(ds)[:, None, None] * w).sum(0) / w.sum(0)
        valid = ~np.isclose(self.dem, self.header.nodata)
        return np.where(valid, out, NODATA)

    def write_report(self, path: str, log: list | None = None) -> None:
        """Standalone HTML report of the current project state (the GUI
        dashboard's role, headless: viz/report.py): shaded terrain map with
        stations, oblique 3-D view, root-zone water content and ponding
        maps (read from the model's device by :func:`state_maps`), plus the
        period's MBR trace when a ``run_period`` log is passed."""
        from criteria3d_tpu_torch.solver import water as W
        from criteria3d_tpu_torch.viz import (HtmlReport, line_chart,
                                              render_map, render_surface3d)
        valid = ~np.isclose(self.dem, self.header.nodata)
        dem = np.where(valid, self.dem, NODATA)
        rep = HtmlReport(f"{self.config.name} — run report")
        rep.section("Terrain")
        rep.figure(render_map(dem, header=self.header,
                              points=self.stations or None, title="DEM"),
                   "Slope-shaded DEM with meteo stations")
        rep.figure(render_surface3d(dem, self.header.cellsize,
                                    rotation_deg=20.0),
                   "Oblique 3-D view")
        if self.model is not None:
            g = self.grid
            swc, pond = state_maps(g, self.params, self.model.water)
            rep.section("State maps")
            rep.figure(render_map(dem, header=self.header, overlay=swc,
                                  overlay_scale="surface_water",
                                  title="ROOT-ZONE WATER CONTENT"),
                       "Root-zone volumetric water content [m3 m-3]")
            rep.figure(render_map(dem, header=self.header, overlay=pond,
                                  overlay_scale="surface_water",
                                  title="PONDING [MM]"),
                       "Surface water level [mm]")
            twc = host_read(W.total_water_content(g, self.params,
                                                  self.model.water.h,
                                                  self.model.water.se))
            rep.section("State")
            rep.table([["grid", f"{g.shape}"], ["nodes", g.n_nodes],
                       ["total water content [m3]", f"{twc:.2f}"]],
                      header=["quantity", "value"])
        if log:
            t = [datetime.datetime.fromisoformat(e["time"]) for e in log]
            mbr = [abs(float(e["mbr"])) for e in log]
            rep.section("Mass balance")
            rep.figure(line_chart({"ABS MBR": (t, mbr)},
                                  title="HOURLY MASS BALANCE RATIO",
                                  ylabel="ABS MBR"),
                       "Per-hour |mass balance ratio| (acceptance gate 1e-3)")
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        rep.write(path)

    # ------------------------------------------------------------------
    # hourly meteo interpolation (interpolationDemMain)
    # ------------------------------------------------------------------
    def _station_arrays(self, var: MeteoVariable,
                        when: datetime.datetime):
        """(x, y, z, values) arrays over stations with gross QC applied
        (checkAndPassDataToInterpolation, spatialControl.cpp:102-334)."""
        xs, ys, zs, vs = [], [], [], []
        rng = QUALITY_RANGES.get(var)
        for st in self.stations:
            if not st.is_active:
                continue
            v = st.hourly_value(var, when)
            if v != NODATA and rng is not None and \
                    not (rng.vmin <= v <= rng.vmax):
                v = NODATA
            # climate-consistency gate on temperature-like values: hourly
            # range anchored on the monthly normals lapse-adjusted to the
            # station height (checkFastValueHourly, quality.cpp:272-330)
            if v != NODATA and not check_fast_value_hourly(
                    var, self.climate, v, when.month, st.altitude):
                v = NODATA
            xs.append(st.utm_x)
            ys.append(st.utm_y)
            zs.append(st.altitude)
            vs.append(v)
        return (np.asarray(xs), np.asarray(ys), np.asarray(zs),
                np.asarray(vs))

    def _thermal_lapse(self, var: MeteoVariable, when: datetime.datetime,
                       zs, vs, active):
        """Thermal-inversion elevation lapse for temperature-like
        variables (regressionOrographyT via regressionOrography,
        interpolation.cpp:1354-1369), with the monthly climate lapse rate
        as fallback slope. None when thermal inversion is disabled."""
        if not self.config.use_thermal_inversion:
            return None
        clim = NODATA
        if self.climate is not None:
            clim = self.climate.lapse_rate(var, when.month, when.day,
                                           when.hour)
        if clim == NODATA:
            clim = -0.006     # DEFAULT_LAPSERATE (meteo.cpp:186)
        return regression_orography_t(
            np.where(active, zs, NODATA), np.where(active, vs, NODATA),
            climate_lapse_rate=clim,
            max_height_inversion=self.config.max_height_inversion,
            min_regression_r2=self.config.min_regression_r2)

    def interpolate_variable(self, var: MeteoVariable,
                             when: datetime.datetime):
        """One variable onto the DEM: gross QC -> spatial QC -> detrended
        IDW (Project::interpolationDemMain, project.cpp:3531-3561).
        Returns the (R, C) map on the grid's device, or None when no
        station reports."""
        xs, ys, zs, vs = self._station_arrays(var, when)
        n_valid = int((vs != NODATA).sum())
        if n_valid == 0:
            return None
        kind = _VAR_KIND.get(var, VariableKind.GENERIC)
        active = vs != NODATA
        if n_valid >= _MIN_STATIONS_FOR_SPATIAL_QC:
            ok = spatial_quality_control(
                xs, ys, zs, np.where(active, vs, NODATA), kind=kind).numpy()
            if ok.any():
                self.qc_rejected += int((active & ~ok).sum())
                active = active & ok
        lapse = None
        if kind == VariableKind.TEMPERATURE:
            lapse = self._thermal_lapse(var, when, zs, vs, active)
        gx, gy = self._grid_xy
        result, _ = detrended_idw(
            xs, ys, zs, vs, gx, gy, self._grid_z, kind=kind,
            min_regression_r2=self.config.min_regression_r2,
            rainfall_threshold=self.config.rainfall_threshold,
            elevation_lapse=lapse, active=active)
        return result

    def _station_transmissivity(self, when: datetime.datetime) -> float:
        """Mean station transmissivity from observed global radiation
        (computeTransmissivity, transmissivity.cpp:105-170): instantaneous
        observed/clear-sky ratio while the sun is up, last value carried
        through the night. The clear-sky potential of every reporting
        station is one vector on the grid's device, read in one copy."""
        cfg = self.config
        tz = cfg.time_zone if not cfg.is_utc else 0
        reporting = []
        for st in self.stations:
            obs = st.hourly_value(MeteoVariable.GLOBAL_IRRADIANCE, when)
            if obs != NODATA:
                reporting.append((st, obs))
        values = []
        if reporting:
            lat = torch.tensor([st.latitude for st, _ in reporting],
                               dtype=torch.float64, device=self.device)
            lon = torch.tensor([st.longitude for st, _ in reporting],
                               dtype=torch.float64, device=self.device)
            sun = rad_mod.sun_position(lat, lon, tz, when.year, when.month,
                                       when.day, when.hour)
            pot = host_array(rad_mod.clear_sky_beam_horizontal(cfg.linke, sun)
                             + rad_mod.clear_sky_diffuse_horizontal(cfg.linke, sun))
            for (st, obs), p in zip(reporting, pot.tolist()):
                if p > 50.0:
                    t = min(max(obs / p, 0.0), 1.0) \
                        * cfg.clear_sky_transmissivity
                    self._station_trans[st.id] = t
                    values.append(t)
                elif st.id in self._station_trans:
                    values.append(self._station_trans[st.id])
        if not values:
            return cfg.clear_sky_transmissivity * 0.75
        return float(np.mean(values))

    def hourly_forcing(self, when: datetime.datetime) -> HourlyForcing:
        """Interpolated forcing maps for one hour on the grid's device
        (interpolateAndSaveHourlyMeteo, criteria3DProject.cpp:2032-2050)."""
        with torch.profiler.record_function(INTERPOLATION_RANGE):
            return self._hourly_forcing(when)

    def _hourly_forcing(self, when: datetime.datetime) -> HourlyForcing:
        cfg = self.config
        shape = self.dem.shape

        def full(v):
            return torch.full(shape, v, dtype=torch.float64, device=self.device)

        t_map = self.interpolate_variable(MeteoVariable.AIR_TEMPERATURE, when)
        if t_map is None:
            raise ValueError(f"no air temperature observations at {when}")

        prec = self.interpolate_variable(MeteoVariable.PRECIPITATION, when)
        if prec is None:
            prec = full(0.0)

        # RH via dew point (useDewPoint + useInterpolationTemperatureForRH,
        # project.cpp interpolationDemMain RH branch)
        rh = None
        if cfg.use_dew_point:
            xs, ys, zs, t_st = self._station_arrays(
                MeteoVariable.AIR_TEMPERATURE, when)
            _, _, _, rh_st = self._station_arrays(
                MeteoVariable.AIR_REL_HUMIDITY, when)
            ok = (t_st != NODATA) & (rh_st != NODATA)
            if ok.any():
                td = meteo_mod.dew_point_from_rh(torch.from_numpy(t_st),
                                                 torch.from_numpy(rh_st))
                td_st = np.where(ok, td.numpy(), NODATA)
                gx, gy = self._grid_xy
                td_lapse = self._thermal_lapse(
                    MeteoVariable.AIR_DEW_TEMPERATURE, when, zs, td_st, ok)
                td_map, _ = detrended_idw(
                    xs, ys, zs, td_st, gx, gy, self._grid_z,
                    kind=VariableKind.TEMPERATURE,
                    min_regression_r2=cfg.min_regression_r2,
                    elevation_lapse=td_lapse, active=ok)
                rh = meteo_mod.rh_from_dew_point(t_map, td_map)
        if rh is None:
            rh = self.interpolate_variable(MeteoVariable.AIR_REL_HUMIDITY,
                                           when)
        if rh is None:
            rh = full(70.0)

        wind = self.interpolate_variable(MeteoVariable.WIND_SCALAR_INTENSITY,
                                         when)
        if wind is None:
            wind = full(cfg.wind_intensity_default)

        trans = self._station_transmissivity(when)
        return HourlyForcing(air_temperature=t_map, precipitation=prec,
                             rel_humidity=rh, wind_speed=wind,
                             transmissivity=trans)

    # ------------------------------------------------------------------
    def output_variables(self) -> dict:
        """[output] ini lists -> {OutputVariable: [depths cm]}
        (project3D.cpp:343-350)."""
        cfg = self.config
        out = {}
        if cfg.output_water_content_depths:
            out[OutputVariable.VOLUMETRIC_WATER_CONTENT] = \
                list(cfg.output_water_content_depths)
        if cfg.output_water_potential_depths:
            out[OutputVariable.WATER_MATRIC_POTENTIAL] = \
                list(cfg.output_water_potential_depths)
        if cfg.output_factor_of_safety_depths:
            out[OutputVariable.FACTOR_OF_SAFETY] = \
                list(cfg.output_factor_of_safety_depths)
        return out

    def run_hour(self, when: datetime.datetime, *,
                 write_outputs: bool = True) -> dict:
        """One hour: interpolation -> model cycle -> outputs
        (runModelHour, criteria3DProject.cpp:2020-2135).

        Output rasters are STAGED (still on the device) and written on the
        next ``run_hour``/``flush_outputs`` call, after that hour's work is
        queued; callers driving ``run_hour`` directly must call
        :meth:`flush_outputs` after the last hour (``run_period`` does)."""
        if self.model is None:
            raise RuntimeError("initialize() first")
        forcing = self.hourly_forcing(when)
        out = self.model.run_hour(forcing, when.year, when.month, when.day,
                                  when.hour)
        out["forcing"] = forcing

        with torch.profiler.record_function(OUTPUTS_RANGE):
            self._flush_staged()
            if write_outputs:
                self._stage_outputs(when, forcing)
        return out

    def _stage_outputs(self, when: datetime.datetime, forcing) -> None:
        variables = self.output_variables()
        if variables:
            raster_dir = os.path.join(self.output_dir, "rasters",
                                      when.strftime("%Y%m%d"))
            if self._raster_writer is None:
                # native C++ worker pool: the raster files are written while
                # the next hour runs (raises when the library cannot build)
                from criteria3d_tpu_torch.native import AsyncRasterWriter
                self._raster_writer = AsyncRasterWriter(n_threads=2)
            self._staged_rasters = compute_output_rasters(
                raster_dir, when.strftime("%Y%m%d_H%H"), self.grid,
                self.params, self.model.water, variables)
        if self.output_points is not None and self.output_points.ids:
            db_path = self.config.output_db_path or \
                os.path.join(self.output_dir, "outputPoints.db")
            os.makedirs(os.path.dirname(db_path), exist_ok=True)
            extra = {"airTemperature": forcing.air_temperature,
                     "precipitation": forcing.precipitation}
            self.output_points.write_hour(
                db_path, when.strftime("%Y-%m-%d %H:%M:%S"), self.grid,
                self.params, self.model.water, variables, extra_maps=extra)

    def run_period(self, start: datetime.datetime, n_hours: int, *,
                   write_outputs: bool = True) -> list[dict]:
        """Hourly loop with the daily crop update at 23h (runModels,
        criteria3DProject.cpp:1169-1318). The MBRs stay on the device
        until the period ends."""
        log = []
        t_min = t_max = None
        for h in range(n_hours):
            when = start + datetime.timedelta(hours=h)
            out = self.run_hour(when, write_outputs=write_outputs)
            # per-cell daily Tmin/Tmax maps (criteria3DProject.cpp:1224)
            t_map = where(self.grid.mask[0], out["forcing"].air_temperature,
                          0.0)
            t_min = t_map if t_min is None else torch.minimum(t_min, t_map)
            t_max = t_map if t_max is None else torch.maximum(t_max, t_map)
            if when.hour == 23:
                self.model.daily_update(t_min, t_max, date=when.date())
                t_min = t_max = None
            log.append(dict(time=str(when), mbr=out["mbr"]))
        self.flush_outputs()
        for e in log:
            e["mbr"] = host_read(e["mbr"])
        return log

    def _flush_staged(self) -> None:
        if self._staged_rasters:
            flush_staged_rasters(self._staged_rasters,
                                 writer=self._raster_writer)
            self._staged_rasters = None

    def flush_outputs(self) -> None:
        """Copy any staged rasters to the host, queue them and wait until
        the writer pool has written them (no-op when none are staged)."""
        with torch.profiler.record_function(OUTPUTS_RANGE):
            self._flush_staged()
            if self._raster_writer is not None:
                self._raster_writer.flush()


def _with_raster_ext(path: str) -> str:
    """Raster paths in the ini may omit the extension."""
    if path.endswith((".flt", ".img", ".asc", ".hdr")):
        return path
    for ext in (".flt", ".img", ".asc"):
        if os.path.exists(path + ext):
            return path + ext
    return path

"""Project and parameter configuration: the reference's two-tier ini schema.

The port's own copy of ``criteria3d_tpu/io/config.py``, line for line;
``ProjectConfig.solver_parameters`` builds the port's ``SolverParameters``.
Parses the same files the reference does (QSettings ini format):

* the project ini (DATA/PROJECT/<name>/<name>.ini): paths to DEM, meteo
  points DB, soil map/DB, land-use map, plus [location] and [output] depth
  lists — loadProjectSettings (agrolib/project/project.cpp);
* parameters.ini (DATA/SETTINGS/parameters.ini): [interpolation], [quality],
  [meteo], [climate] monthly series, [radiation], [snow], [soilWaterFluxes]
  — Project3D::loadProject3DParameters (src/project3D/project3D.cpp:200-450).

Values are exposed as plain dataclasses; `SolverParameters` is derived from
[soilWaterFluxes] via the modelAccuracy rule (project3D.cpp:619-652).
"""

from __future__ import annotations

import configparser
import dataclasses
import os

from criteria3d_tpu_torch.core.state import SolverParameters

__all__ = ["ProjectConfig", "load_project_ini", "load_parameters_ini"]


def _parse_list(s: str) -> list[float]:
    return [float(v) for v in s.split(",") if v.strip()]


def _read_ini(path: str) -> configparser.ConfigParser:
    cp = configparser.ConfigParser(inline_comment_prefixes=("#", ";"))
    cp.optionxform = str.lower
    with open(path) as f:
        text = f.read()
    # optionxform lowercases OPTION names only; section headers like
    # [soilWaterFluxes] must be normalised too or has_section() misses them
    import re
    text = re.sub(r"^\s*\[([^\]]+)\]",
                  lambda m: "[" + m.group(1).strip().lower() + "]",
                  text, flags=re.M)
    cp.read_string(text)
    return cp


@dataclasses.dataclass
class ProjectConfig:
    """Everything needed to set a project up."""

    name: str = ""
    path: str = ""
    # [location]
    latitude: float = 45.0
    longitude: float = 10.0
    utm_zone: int = 32
    time_zone: int = 1
    is_utc: bool = True
    # [project] paths (relative to the project dir)
    dem_path: str = ""
    meteo_points_path: str = ""
    soil_map_path: str = ""
    soil_db_path: str = ""
    landuse_map_path: str = ""
    crop_db_path: str = ""
    output_points_path: str = ""
    output_db_path: str = ""
    # VINE3D: fields/cultivar/training/field-book DB
    # (VINE3D_test.ini [project] vine3d_db; vine3DProject.cpp:151)
    vine3d_db_path: str = ""
    # [simulation]
    compute_heat: bool = False
    compute_diseases: bool = True
    # [output] depth lists [cm]
    output_water_content_depths: tuple = ()
    output_water_potential_depths: tuple = ()
    output_factor_of_safety_depths: tuple = ()
    # [soilWaterFluxes]
    is_initial_water_potential: bool = True
    initial_water_potential: float = -2.0
    initial_degree_of_saturation: float = 0.8
    compute_only_surface: bool = False
    compute_all_soil_depth: bool = True
    imposed_computation_depth: float = 1.0
    conductivity_horiz_vert_ratio: float = 10.0
    free_catchment_runoff: bool = True
    free_bottom_drainage: bool = True
    free_lateral_drainage: bool = True
    model_accuracy: int = 3
    number_of_threads: int = 4
    # [radiation]
    linke: float = 4.0
    albedo: float = 0.2
    clear_sky_transmissivity: float = 0.75
    shadowing: bool = True
    real_sky: bool = True
    # [snow]
    snow_params: dict = dataclasses.field(default_factory=dict)
    # [interpolation]
    min_regression_r2: float = 0.1
    interpolation_algorithm: str = "idw"
    use_thermal_inversion: bool = True   # interpolationSettings.cpp:348
    max_height_inversion: float = 1000.0
    use_dew_point: bool = True
    # [meteo]
    rainfall_threshold: float = 0.2
    samani_coefficient: float = 0.17
    wind_intensity_default: float = 2.0
    # [climate]
    climate_monthly: dict = dataclasses.field(default_factory=dict)

    def solver_parameters(self, cell_size: float) -> SolverParameters:
        import dataclasses as _dc
        p = SolverParameters.from_model_accuracy(self.model_accuracy,
                                                 cell_size)
        p = _dc.replace(
            p, lateral_vertical_ratio=self.conductivity_horiz_vert_ratio)
        if self.compute_heat:
            # the reference app enables vapor+advection with heat
            # (initializeSF3D flags, project3D.cpp:546)
            p = _dc.replace(p, heat_vapor=True, heat_advection=True)
        return p


def load_project_ini(path: str) -> ProjectConfig:
    """Read a <project>.ini (Montue.ini-style) into a ProjectConfig."""
    cp = _read_ini(path)
    cfg = ProjectConfig()
    cfg.path = os.path.dirname(os.path.abspath(path))

    if cp.has_section("location"):
        loc = cp["location"]
        cfg.latitude = loc.getfloat("lat", cfg.latitude)
        cfg.longitude = loc.getfloat("lon", cfg.longitude)
        cfg.utm_zone = loc.getint("utm_zone", cfg.utm_zone)
        cfg.time_zone = loc.getint("time_zone", cfg.time_zone)
        cfg.is_utc = loc.getboolean("is_utc", cfg.is_utc)

    if cp.has_section("project"):
        prj = cp["project"]
        cfg.name = prj.get("name", "")
        rel = lambda p: os.path.normpath(os.path.join(cfg.path, p)) if p else ""
        cfg.dem_path = rel(prj.get("dem", ""))
        cfg.meteo_points_path = rel(prj.get("meteo_points", ""))
        cfg.soil_map_path = rel(prj.get("soil_map", ""))
        cfg.soil_db_path = rel(prj.get("soil_db", ""))
        cfg.landuse_map_path = rel(prj.get("landuse_map", ""))
        cfg.crop_db_path = rel(prj.get("crop_db", ""))
        cfg.output_points_path = rel(prj.get("output_points", ""))
        cfg.output_db_path = rel(prj.get("output_db", ""))
        cfg.vine3d_db_path = rel(prj.get("vine3d_db", ""))

    if cp.has_section("simulation"):
        cfg.compute_heat = cp["simulation"].getboolean("compute_heat", False)

    if cp.has_section("output"):
        out = cp["output"]
        cfg.output_water_content_depths = tuple(
            _parse_list(out.get("watercontent", "")))
        cfg.output_water_potential_depths = tuple(
            _parse_list(out.get("waterpotential", "")))
        cfg.output_factor_of_safety_depths = tuple(
            _parse_list(out.get("factorofsafety", "")))

    if cp.has_section("settings"):
        cfg.compute_diseases = cp["settings"].getboolean(
            "compute_diseases", cfg.compute_diseases)
        params_file = cp["settings"].get("parameters_file", "")
        if params_file:
            params_path = os.path.normpath(os.path.join(cfg.path, params_file))
            if os.path.exists(params_path):
                load_parameters_ini(params_path, cfg)

    return cfg


def load_parameters_ini(path: str, cfg: ProjectConfig | None = None) -> ProjectConfig:
    """Read a parameters.ini into (or onto) a ProjectConfig."""
    if cfg is None:
        cfg = ProjectConfig()
    cp = _read_ini(path)

    if cp.has_section("soilwaterfluxes"):
        s = cp["soilwaterfluxes"]
        cfg.is_initial_water_potential = s.getboolean(
            "isinitialwaterpotential", cfg.is_initial_water_potential)
        cfg.initial_water_potential = s.getfloat(
            "initialwaterpotential", cfg.initial_water_potential)
        cfg.initial_degree_of_saturation = s.getfloat(
            "initialdegreeofsaturation", cfg.initial_degree_of_saturation)
        cfg.compute_only_surface = s.getboolean(
            "computeonlysurface", cfg.compute_only_surface)
        cfg.compute_all_soil_depth = s.getboolean(
            "computeallsoildepth", cfg.compute_all_soil_depth)
        cfg.imposed_computation_depth = s.getfloat(
            "imposedcomputationdepth", cfg.imposed_computation_depth)
        cfg.conductivity_horiz_vert_ratio = s.getfloat(
            "conductivityhorizvertratio", cfg.conductivity_horiz_vert_ratio)
        cfg.free_catchment_runoff = s.getboolean(
            "freecatchmentrunoff", cfg.free_catchment_runoff)
        cfg.free_bottom_drainage = s.getboolean(
            "freebottomdrainage", cfg.free_bottom_drainage)
        cfg.free_lateral_drainage = s.getboolean(
            "freelateraldrainage", cfg.free_lateral_drainage)
        cfg.model_accuracy = s.getint("modelaccuracy", cfg.model_accuracy)
        cfg.number_of_threads = s.getint("numberofthreads", cfg.number_of_threads)

    if cp.has_section("radiation"):
        r = cp["radiation"]
        cfg.linke = r.getfloat("linke", cfg.linke)
        cfg.albedo = r.getfloat("albedo", cfg.albedo)
        cfg.clear_sky_transmissivity = r.getfloat("clear_sky",
                                                  cfg.clear_sky_transmissivity)
        cfg.shadowing = r.getboolean("shadowing", cfg.shadowing)
        cfg.real_sky = r.getboolean("real_sky", cfg.real_sky)

    if cp.has_section("snow"):
        cfg.snow_params = {k: float(v) for k, v in cp["snow"].items()}

    if cp.has_section("interpolation"):
        i = cp["interpolation"]
        cfg.min_regression_r2 = i.getfloat("minregressionr2",
                                           cfg.min_regression_r2)
        cfg.interpolation_algorithm = i.get("algorithm",
                                            cfg.interpolation_algorithm)
        cfg.use_thermal_inversion = i.getboolean("thermalinversion",
                                                 cfg.use_thermal_inversion)
        cfg.use_dew_point = i.getboolean("usedewpoint", cfg.use_dew_point)

    if cp.has_section("meteo"):
        m = cp["meteo"]
        cfg.rainfall_threshold = m.getfloat("prec_threshold",
                                            cfg.rainfall_threshold)
        cfg.samani_coefficient = m.getfloat("samani_coefficient",
                                            cfg.samani_coefficient)
        wind_default = m.getfloat("wind_intensity_default", 0.0)
        if wind_default > 0:
            cfg.wind_intensity_default = wind_default

    if cp.has_section("climate"):
        cfg.climate_monthly = {k: _parse_list(v)
                               for k, v in cp["climate"].items()}

    return cfg

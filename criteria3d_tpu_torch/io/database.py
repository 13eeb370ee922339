"""SQLite database readers: soils, crops/land units, meteo points.

The port's own copy of ``criteria3d_tpu/io/database.py``, line for line:
sqlite3 and numpy, with scipy imported only inside
:func:`fit_van_genuchten`, as in the JAX package. ``CropRecord.to_parameters``
builds the port's ``CropParameters``; ``read_fields_db`` builds the port's
``TrainingSystem``.

Python re-implementation of the reference's Qt-SQL persistence layer:

* soil DB (agrolib/soil/soilDbTools.cpp): ``soils`` + ``horizons`` +
  ``van_genuchten`` texture-class defaults + ``water_retention``
  measurements, with van Genuchten curve fitting when lab data exist;
* crop DB (agrolib/crop/cropDbTools.cpp): ``crop`` and ``land_units``
  (roughness/pond per land use);
* meteo points DB (agrolib/dbMeteoPoints/dbMeteoPointsHandler.h:22-75):
  ``point_properties`` + per-point daily/hourly series tables.

Schemas are validated against the reference sample projects
(DATA/PROJECT/Montue, DATA/TEMPLATE).
"""

from __future__ import annotations

import dataclasses
import sqlite3

import numpy as np

from criteria3d_tpu_torch.constants import GRAVITY, DAY_SECONDS, NODATA

__all__ = ["SoilHorizon", "SoilProfile", "read_soil_db", "fit_van_genuchten",
           "usda_texture_class", "CropRecord", "read_crop_db",
           "read_land_units", "MeteoPoint", "read_meteo_points_db",
           "read_fields_db"]


def _ro(path: str) -> sqlite3.Connection:
    return sqlite3.connect(f"file:{path}?mode=ro", uri=True)


# ----------------------------------------------------------------------
# soils
# ----------------------------------------------------------------------

# USDA texture-class van Genuchten defaults as shipped in the reference DBs
# (table ``van_genuchten``; alpha [kPa-1], he [kPa], k_sat [cm/d]).

@dataclasses.dataclass
class SoilHorizon:
    upper_depth: float      # [m]
    lower_depth: float      # [m]
    sand: float = NODATA    # [%]
    silt: float = NODATA
    clay: float = NODATA
    coarse_fragments: float = 0.0   # [-]
    organic_matter: float = 0.02    # [-]
    bulk_density: float = NODATA    # [g cm-3]
    # van Genuchten (converted to model units)
    vg_alpha: float = NODATA        # [m-1]
    vg_n: float = NODATA
    vg_he: float = NODATA           # [m]
    theta_r: float = NODATA
    theta_s: float = NODATA
    k_sat: float = NODATA           # [m s-1]
    mualem_l: float = 0.5
    effective_cohesion: float = NODATA  # [kPa]
    friction_angle: float = NODATA      # [deg]

    @property
    def soil_fraction(self):
        return 1.0 - self.coarse_fragments


@dataclasses.dataclass
class SoilProfile:
    id_soil: int
    code: str
    name: str
    horizons: list

    @property
    def total_depth(self):
        return self.horizons[-1].lower_depth if self.horizons else 0.0

    def horizon_at(self, depth: float) -> SoilHorizon | None:
        for h in self.horizons:
            if h.upper_depth - 1e-9 <= depth <= h.lower_depth + 1e-9:
                return h
        return None


def usda_texture_class(sand, silt, clay) -> int:
    """USDA texture-triangle class id 1-12 (getUSDATextureClass,
    agrolib/soil/soil.cpp:252-289) — the key of the ``van_genuchten``
    texture-class defaults table. Returns NODATA when the fractions are
    missing or don't sum to ~100%."""
    if sand in (None, NODATA) or clay in (None, NODATA):
        return int(NODATA)
    if silt in (None, NODATA):
        silt = 100.0 - sand - clay
    if abs(sand + clay + silt - 100.0) > 2.0:
        return int(NODATA)

    cls = int(NODATA)
    if clay >= 40:
        cls = 12                                       # clay
    if silt >= 40 and clay >= 40:
        cls = 11                                       # silty clay
    if clay >= 35 and sand >= 45:
        cls = 10                                       # sandy clay
    if (clay < 27.5 and 50 <= silt <= 80) or (clay >= 12.5 and silt >= 80):
        cls = 4                                        # silty loam
    if clay < 12.5 and silt >= 80:
        cls = 6                                        # silt
    if clay < 40 and sand < 20 and clay >= 27.5:
        cls = 8                                        # silty clay loam
    if (clay < 20 and sand >= 52.5) or \
            (clay < 7.5 and silt < 50 and 42.5 <= sand <= 52.5):
        cls = 3                                        # sandy loam
    if sand >= 70 and clay <= sand - 70:
        cls = 2                                        # loamy sand
    if sand >= 85 and clay <= 2 * sand - 170:
        cls = 1                                        # sand
    if 20 <= clay < 35 and sand >= 45 and silt < 27.5:
        cls = 7                                        # sandy clay loam
    if 7.5 <= clay < 27.5 and sand < 52.5 and 27.5 <= silt < 50:
        cls = 5                                        # loam
    if 27.5 <= clay < 40 and 20 <= sand < 45:
        cls = 9                                        # clay loam
    return cls


def read_soil_db(path: str, fitting: bool = True) -> dict[str, SoilProfile]:
    """Read all soils with horizons; fit VG parameters from water-retention
    data when available, else use the texture-class defaults table."""
    db = _ro(path)
    cur = db.cursor()

    # texture-class defaults keyed by the USDA class id (the table's
    # id_texture primary key; loadVanGenuchtenParameters, soilDbTools.cpp)
    vg_defaults = {}
    try:
        for row in cur.execute(
                "SELECT id_texture, alpha, n, he, theta_r, theta_s, k_sat, l "
                "FROM van_genuchten"):
            vg_defaults[int(row[0])] = row[1:]
    except sqlite3.OperationalError:
        pass

    # lab water-retention data: {(code, horizon): [(potential kPa, theta)]}
    retention = {}
    try:
        for code, hor, pot, theta in cur.execute(
                "SELECT soil_code, horizon_nr, water_potential, water_content "
                "FROM water_retention"):
            retention.setdefault((code, hor), []).append((float(pot), float(theta)))
    except sqlite3.OperationalError:
        pass

    hcols = {c[1] for c in cur.execute("PRAGMA table_info('horizons')")}
    opt = lambda c: c if c in hcols else "NULL"
    hquery = ("SELECT horizon_nr, upper_depth, lower_depth, "
              f"{opt('coarse_fragment')}, {opt('organic_matter')}, "
              f"{opt('sand')}, {opt('silt')}, {opt('clay')}, "
              f"{opt('bulk_density')}, {opt('theta_sat')}, {opt('k_sat')}, "
              f"{opt('effective_cohesion')}, {opt('friction_angle')} "
              "FROM horizons WHERE soil_code=? ORDER BY horizon_nr")

    soils = {}
    hcur = db.cursor()
    for id_soil, code, name, _info in cur.execute(
            "SELECT id_soil, soil_code, name, info FROM soils").fetchall():
        horizons = []
        for row in hcur.execute(hquery, (code,)).fetchall():
            (hor_nr, up, low, coarse, om, sand, silt, clay, bd,
             theta_sat, ksat_cmd, coh, fric) = row
            h = SoilHorizon(
                upper_depth=float(up) / 100.0, lower_depth=float(low) / 100.0,
                sand=sand or NODATA, silt=silt or NODATA, clay=clay or NODATA,
                coarse_fragments=float(coarse or 0.0),
                organic_matter=float(om or 2.0) / 100.0,
                bulk_density=bd if bd not in (None, "") else NODATA,
                effective_cohesion=coh if coh is not None else NODATA,
                friction_angle=fric if fric is not None else NODATA)

            # class defaults from the texture triangle
            tex = usda_texture_class(h.sand, h.silt, h.clay)
            if tex in vg_defaults:
                alpha_kpa, n, he_kpa, tr, ts, ks_cmd, l = vg_defaults[tex]
                h.vg_alpha = float(alpha_kpa) * GRAVITY    # [kPa-1] -> [m-1]
                h.vg_n = float(n)
                h.vg_he = float(he_kpa) / GRAVITY          # [kPa] -> [m]
                h.theta_r = float(tr)
                h.theta_s = float(ts)
                h.k_sat = float(ks_cmd) * 0.01 / DAY_SECONDS
                h.mualem_l = float(l)

            # DB-level overrides
            if theta_sat not in (None, ""):
                h.theta_s = float(theta_sat)
            if ksat_cmd not in (None, ""):
                h.k_sat = float(ksat_cmd) * 0.01 / DAY_SECONDS

            # curve fitting from lab data (soil.cpp fittingWaterRetentionCurve)
            data = retention.get((code, hor_nr))
            if fitting and data and len(data) >= 4:
                fit = fit_van_genuchten(np.array(data), theta_s0=h.theta_s)
                if fit is not None:
                    h.vg_alpha, h.vg_n, h.theta_r, h.theta_s = fit

            horizons.append(h)
        # several id_soil rows may share one soil_code (the VINE3D_test DB
        # maps 7 map units onto 4 profiles); every id_soil must survive so
        # the soil map's id -> profile join resolves (setSoilIndexMap keys
        # by id_soil, project3D.cpp:736-742)
        key = code if code not in soils else f"{code}#{id_soil}"
        soils[key] = SoilProfile(id_soil=id_soil, code=code,
                                 name=name or code, horizons=horizons)
    db.close()
    return soils


def fit_van_genuchten(data_kpa_theta: np.ndarray, theta_s0: float = 0.45):
    """Least-squares fit of (alpha [m-1], n, theta_r, theta_s) to
    water-retention pairs (|potential| [kPa], theta).

    The reference uses a Marquardt fit (soil.cpp Crit3DFittingOptions,
    furtherMathFunctions.cpp); scipy's least_squares is the equivalent here.
    """
    try:
        from scipy.optimize import least_squares
    except ImportError:
        return None

    psi_m = np.abs(data_kpa_theta[:, 0]) / GRAVITY   # [kPa] -> [m]
    theta = data_kpa_theta[:, 1]
    if theta.max() > 1.5:    # [%] in some DBs
        theta = theta / 100.0

    ts0 = theta_s0 if theta_s0 not in (None, NODATA) else float(theta.max())

    def residuals(p):
        alpha, n, tr, ts = p
        se = (1.0 + (alpha * np.maximum(psi_m, 1e-9)) ** n) ** (-(1.0 - 1.0 / n))
        return tr + se * (ts - tr) - theta

    try:
        res = least_squares(
            residuals, x0=[1.0, 1.3, 0.05, ts0],
            bounds=([0.01, 1.01, 0.0, 0.2], [20.0, 3.0, 0.2, 0.6]))
    except Exception:
        return None
    if not res.success:
        return None
    alpha, n, tr, ts = res.x
    return float(alpha), float(n), float(tr), float(ts)


# ----------------------------------------------------------------------
# crops / land units
# ----------------------------------------------------------------------

@dataclasses.dataclass
class CropRecord:
    id_crop: str
    name: str
    lai_min: float
    lai_max: float
    thermal_threshold: float
    upper_thermal_threshold: float
    degree_days_emergence: float
    degree_days_lai_increase: float
    degree_days_lai_decrease: float
    lai_curve_a: float
    lai_curve_b: float
    root_depth_zero: float
    root_depth_max: float
    root_shape_deformation: float
    degree_days_root_increase: float
    kc_max: float
    raw_fraction: float

    def to_parameters(self):
        from criteria3d_tpu_torch.physics.crop import CropParameters
        return CropParameters(
            lai_min=self.lai_min, lai_max=self.lai_max,
            lai_curve_a=self.lai_curve_a, lai_curve_b=self.lai_curve_b,
            thermal_threshold=self.thermal_threshold,
            upper_thermal_threshold=self.upper_thermal_threshold,
            degree_days_increase=self.degree_days_lai_increase,
            degree_days_decrease=self.degree_days_lai_decrease,
            degree_days_emergence=self.degree_days_emergence,
            kc_max=self.kc_max, f_raw=self.raw_fraction,
            root_depth_min=self.root_depth_zero,
            root_depth_max=self.root_depth_max,
            degree_days_root_growth=self.degree_days_root_increase,
            root_shape_deformation=self.root_shape_deformation)


def read_crop_db(path: str) -> dict[str, CropRecord]:
    db = _ro(path)
    cur = db.cursor()
    crops = {}
    for row in cur.execute(
            "SELECT id_crop, crop_name, lai_min, lai_max, thermal_threshold, "
            "upper_thermal_threshold, degree_days_emergence, "
            "degree_days_lai_increase, degree_days_lai_decrease, "
            "lai_curve_factor_a, lai_curve_factor_b, root_depth_zero, "
            "root_depth_max, root_shape_deformation, "
            "degree_days_root_increase, kc_max, raw_fraction FROM crop"):
        crops[row[0]] = CropRecord(
            id_crop=row[0], name=row[1],
            lai_min=row[2] or 0.2, lai_max=row[3] or 4.0,
            thermal_threshold=row[4] or 0.0,
            upper_thermal_threshold=row[5] or 30.0,
            degree_days_emergence=row[6] or 80.0,
            degree_days_lai_increase=row[7] or 1200.0,
            degree_days_lai_decrease=row[8] or 2000.0,
            lai_curve_a=row[9] or 5.0,
            lai_curve_b=-abs(row[10] or 0.01),
            root_depth_zero=row[11] or 0.05,
            root_depth_max=row[12] or 0.8,
            root_shape_deformation=row[13] or 1.0,
            degree_days_root_increase=row[14] or 1000.0,
            kc_max=row[15] or 1.2,
            raw_fraction=row[16] or 0.55)
    db.close()
    return crops


def read_land_units(path: str) -> list[dict]:
    """Land units (id, landuse type, roughness, pond)
    — Crit3DLandUnit (agrolib/crop/landUnit.h)."""
    db = _ro(path)
    cur = db.cursor()
    units = []
    try:
        for row in cur.execute(
                "SELECT id_unit, name, id_landuse, id_crop, roughness, pond "
                "FROM land_units"):
            units.append(dict(id_unit=row[0], name=row[1], landuse=row[2],
                              id_crop=row[3], roughness=row[4] or 0.05,
                              pond=row[5] or 0.002))
    except sqlite3.OperationalError:
        pass
    if not units:
        # fall back to the land_use class table (template DBs)
        for i, row in enumerate(cur.execute(
                "SELECT id_landuse, type, roughness, pond FROM land_use")):
            rough = float(row[2]) if row[2] not in (None, "") else 0.05
            pond = float(row[3]) if row[3] not in (None, "") else 0.002
            units.append(dict(id_unit=i, name=row[1], landuse=row[0],
                              id_crop=None, roughness=rough, pond=pond))
    db.close()
    return units


# ----------------------------------------------------------------------
# meteo points
# ----------------------------------------------------------------------

@dataclasses.dataclass
class MeteoPoint:
    id: str
    name: str
    latitude: float
    longitude: float
    utm_x: float
    utm_y: float
    altitude: float
    daily: dict = dataclasses.field(default_factory=dict)   # var -> np arrays


def read_meteo_points_db(path: str) -> list[MeteoPoint]:
    """Read station properties + any per-point series tables.

    Handles both the full schema (point_properties with utm_x/utm_y and
    <id>_D / <id>_H tables, dbMeteoPointsHandler.h) and the simplified
    meteo1D schema (table_name column + daily tmin/tmax/tavg/prec)."""
    db = _ro(path)
    cur = db.cursor()
    cols = [c[1] for c in cur.execute("PRAGMA table_info('point_properties')")]
    points = []

    if "utm_x" in cols:
        rows = cur.execute(
            "SELECT id_point, name, latitude, longitude, utm_x, utm_y, "
            "altitude FROM point_properties").fetchall()
        for r in rows:
            points.append(MeteoPoint(id=str(r[0]), name=r[1] or str(r[0]),
                                     latitude=r[2], longitude=r[3],
                                     utm_x=r[4], utm_y=r[5],
                                     altitude=r[6] or 0.0))
        table_for = {p.id: (f"{p.id}_D", f"{p.id}_H") for p in points}
    else:
        rows = cur.execute(
            "SELECT id_meteo, table_name, meteo_name, longitude, latitude, "
            "height FROM point_properties").fetchall()
        for r in rows:
            points.append(MeteoPoint(id=str(r[0]), name=r[2] or str(r[0]),
                                     latitude=r[4], longitude=r[3],
                                     utm_x=NODATA, utm_y=NODATA,
                                     altitude=r[5] or 0.0))
        table_for = {p.id: (rows[i][1], None) for i, p in enumerate(points)}

    tables = {r[0] for r in cur.execute(
        "SELECT name FROM sqlite_master WHERE type='table'")}
    for p in points:
        daily_t, _ = table_for[p.id]
        if daily_t in tables:
            tcols = [c[1] for c in cur.execute(f"PRAGMA table_info('{daily_t}')")]
            data = cur.execute(f"SELECT * FROM '{daily_t}' ORDER BY 1").fetchall()
            if data:
                arr = {c: [] for c in tcols}
                for row in data:
                    for c, v in zip(tcols, row):
                        arr[c].append(v)
                p.daily = {c: (np.asarray(v) if c in ("date", "date_time")
                               else np.asarray(
                                   [float(x) if x is not None else NODATA
                                    for x in v]))
                           for c, v in arr.items()}
    db.close()
    return points


# ----------------------------------------------------------------------
# VINE3D fields DB (bin/VINE3D/vine3DProject.cpp:271-644)
# ----------------------------------------------------------------------

def read_fields_db(path: str) -> dict:
    """Read a VINE3D fields database (VINE3D_test/DATA/fields.db schema):
    ``cultivar``, ``training_system``, ``fields`` and ``field_book`` tables
    (loadTrainingSystems / loadFieldsProperties / loadFieldBook,
    vine3DProject.cpp:271-644).

    Returns dict(cultivars=..., training_systems=..., fields=...,
    field_book=[FieldBookEntry-like dicts]).
    """
    import datetime as _dt

    from criteria3d_tpu_torch.physics.grapevine import TrainingSystem

    db = _ro(path)
    cur = db.cursor()

    cultivars = {}
    for row in cur.execute(
            "SELECT id_cultivar, name, phenovitis_critical_chilling, "
            "phenovitis_force_veraison, phenovitis_force_physiological_maturity, "
            "degree_days_veraison, hydrall_stress_threshold, "
            "miglietta_fruit_biomass_offset, miglietta_fruit_biomass_slope "
            "FROM cultivar"):
        cultivars[int(row[0])] = dict(
            id=int(row[0]), name=row[1],
            critical_chilling=row[2], critical_force_veraison=row[3],
            critical_force_maturity=row[4], degree_days_veraison=row[5],
            water_stress_threshold=row[6],
            fruit_biomass_offset=row[7], fruit_biomass_slope=row[8])

    training = {}
    for row in cur.execute(
            "SELECT id_training_system, name, nr_shoots_plant, row_width, "
            "row_height, row_distance, plant_distance FROM training_system"):
        training[int(row[0])] = TrainingSystem(
            id=int(row[0]), name=row[1] or "", shoots_per_plant=row[2],
            row_width=row[3], row_height=row[4], row_distance=row[5],
            plant_distance=row[6])

    fields = {}
    for row in cur.execute(
            "SELECT id_field, id_cultivar, id_training_system, "
            "irrigation_max_rate, max_lai_grass, landuse FROM fields"):
        fields[int(row[0])] = dict(
            id=int(row[0]), id_cultivar=int(row[1]),
            id_training_system=int(row[2]),
            max_irrigation_rate=float(row[3] or 0.0),
            max_lai_grass=float(row[4] or 1.0),
            landuse=str(row[5] or "UNDEFINED"))

    field_book = []
    try:
        for row in cur.execute(
                "SELECT id_field, date_, irrigation_hours, pinchout, "
                "leaf_removal, harvesting_performed, cluster_thinning, "
                "thinning_percentage FROM field_book ORDER BY date_"):
            date = _dt.datetime.fromisoformat(str(row[1])[:19]).date()
            if row[2]:
                field_book.append(dict(date=date, field=int(row[0]),
                                       operation="irrigation",
                                       quantity=float(row[2])))
            if row[3]:
                field_book.append(dict(date=date, field=int(row[0]),
                                       operation="trimming",
                                       quantity=float(row[3])))
            if row[4]:
                field_book.append(dict(date=date, field=int(row[0]),
                                       operation="leafRemoval",
                                       quantity=float(row[4])))
            if row[6]:
                field_book.append(dict(date=date, field=int(row[0]),
                                       operation="clusterThinning",
                                       quantity=float(row[7] or 0.0)))
            if row[5]:
                field_book.append(dict(date=date, field=int(row[0]),
                                       operation="harvesting", quantity=0.0))
    except sqlite3.OperationalError:
        pass

    db.close()
    return dict(cultivars=cultivars, training_systems=training,
                fields=fields, field_book=field_book)

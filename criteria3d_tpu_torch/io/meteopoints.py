"""Meteo points database: full read/write/import handler.

The port's own copy of ``criteria3d_tpu/io/meteopoints.py``, line for line
(sqlite3 and numpy); :func:`synthesize_hourly_from_daily` takes the sun's
position from the port's ``physics/radiation.py`` on the CPU.

Python analogue of Crit3DMeteoPointsDbHandler
(agrolib/dbMeteoPoints/dbMeteoPointsHandler.h:22-75): a SQLite station DB
with a ``point_properties`` table, a ``variable_properties`` catalogue and
per-point data tables ``<id>_H`` (hourly) / ``<id>_D`` (daily) holding
``(date_time, id_variable, value)`` rows — the schema of
DATA/TEMPLATE/template_meteo.db.

Covers the write/import half the round-1 reader lacked:

* :meth:`MeteoPointsDB.create` — new DB with the template schema;
* :meth:`MeteoPointsDB.write_point_properties` — station upsert;
* :meth:`MeteoPointsDB.write_hourly` / `write_daily` — series insert
  (writeHourlyDataList/writeDailyDataList, dbMeteoPointsHandler.cpp:1616+);
* :meth:`MeteoPointsDB.import_hourly_csv` — the fixed CSV import format
  ``DATE,HOUR,TAVG,PREC,RHAVG,RAD,W_SCAL_INT`` with syntactic quality
  control (importHourlyMeteoData, dbMeteoPointsHandler.cpp:1437-1580);
* :meth:`MeteoPointsDB.read_stations` — stations + hourly/daily series into
  :class:`~criteria3d_tpu_torch.core.meteo.MeteoStation` containers.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import sqlite3

import numpy as np

from criteria3d_tpu_torch.constants import NODATA
from criteria3d_tpu_torch.core.meteo import (DAILY_DB_IDS, HOURLY_DB_IDS,
                                             QUALITY_RANGES, MeteoStation,
                                             MeteoVariable, variable_from_db_id)

__all__ = ["MeteoPointsDB", "synthesize_hourly_from_daily"]

# variable_properties rows as shipped in DATA/TEMPLATE/template_meteo.db
_VARIABLE_PROPERTIES = [
    (101, "TAVG", "hourly average air temperature at 2 m", "3600", 2.0, "0.1", "C", -50.0, 60.0),
    (102, "PREC", "hourly cumulated precipitation", "3600", 2.0, "0.1", "mm", 0.0, 200.0),
    (103, "RHAVG", "hourly average relative air humidity at 2 m", "3600", 2.0, "1", "%", 0.0, 100.0),
    (104, "RAD", "hourly average global radiation flux", "3600", 2.0, "1", "W m-2", 0.0, 1360.0),
    (105, "W_SCAL_INT", "hourly scalar average wind intensity at 10 m", "3600", 10.0, "0.1", "m s-1", 0.0, 100.0),
    (106, "W_VEC_DIR", "hourly prevailing wind direction at 10 m", "3600", 10.0, "1", "deg", 0.0, 360.0),
    (108, "LEAFW", "hourly leaf wetness", "3600", 2.0, "1", "-", 0.0, 1.0),
    (109, "ET0", "hourly potential evapotranspiration", "3600", 2.0, "0.1", "mm", 0.0, 10.0),
    (151, "DAILY_TMIN", "daily minimum air temperature at 2 m", "86400", 2.0, "0.1", "C", -50.0, 60.0),
    (152, "DAILY_TMAX", "daily maximum air temperature at 2 m", "86400", 2.0, "0.1", "C", -50.0, 60.0),
    (153, "DAILY_TAVG", "daily average air temperature at 2 m", "86400", 2.0, "0.1", "C", -50.0, 60.0),
    (154, "DAILY_PREC", "daily cumulated precipitation", "86400", 2.0, "0.1", "mm", 0.0, 1000.0),
    (155, "DAILY_RHMIN", "daily minimum relative air humidity at 2 m", "86400", 2.0, "1", "%", 0.0, 100.0),
    (156, "DAILY_RHMAX", "daily maximum relative air humidity at 2 m", "86400", 2.0, "1", "%", 0.0, 100.0),
    (157, "DAILY_RHAVG", "daily average relative air humidity at 2 m", "86400", 2.0, "1", "%", 0.0, 100.0),
    (158, "DAILY_RAD", "daily average global radiation", "86400", 2.0, "0.1", "MJ m-2", 0.0, 50.0),
    (159, "DAILY_W_SCAL_INT_AVG", "daily scalar average wind intensity at 10 m", "86400", 10.0, "0.1", "m s-1", 0.0, 100.0),
    (170, "DAILY_ET0_HS", "daily potential evapotranspiration (Hargreaves)", "86400", 2.0, "0.1", "mm", 0.0, 50.0),
    (171, "DAILY_ET0_PM", "daily potential evapotranspiration (Penman)", "86400", 2.0, "0.1", "mm", 0.0, 50.0),
    (172, "DAILY_WATER_TABLE_DEPTH", "daily watertable depth", "86400", "", "0.01", "m", 0.0, None),
]

# the fixed hourly CSV import columns (importHourlyMeteoData,
# dbMeteoPointsHandler.cpp:1432-1433): position -> variable
_CSV_COLUMNS = [
    (2, MeteoVariable.AIR_TEMPERATURE),
    (3, MeteoVariable.PRECIPITATION),
    (4, MeteoVariable.AIR_REL_HUMIDITY),
    (5, MeteoVariable.GLOBAL_IRRADIANCE),
    (6, MeteoVariable.WIND_SCALAR_INTENSITY),
]


class MeteoPointsDB:
    """SQLite meteo-points database handler (read + write + import)."""

    def __init__(self, path: str, create: bool = False):
        if not create and not os.path.exists(path):
            raise FileNotFoundError(path)
        self.path = path
        self.db = sqlite3.connect(path)
        if create:
            self._create_schema()

    def close(self):
        self.db.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------
    def _create_schema(self):
        cur = self.db.cursor()
        cur.execute(
            "CREATE TABLE IF NOT EXISTS point_properties "
            "(id_point TEXT, name TEXT, dataset TEXT, latitude REAL, "
            "longitude REAL, latInt INTEGER, lonInt INTEGER, utm_x NUMERIC, "
            "utm_y NUMERIC, altitude REAL, state TEXT, region TEXT, "
            "province TEXT, municipality TEXT, is_active INTEGER, "
            "is_utc INTEGER, orog_code NUMERIC, PRIMARY KEY(id_point))")
        cur.execute(
            "CREATE TABLE IF NOT EXISTS variable_properties "
            "(id_variable INTEGER, variable TEXT, description TEXT, "
            "frequency TEXT, height REAL, resolution TEXT, unit INTEGER, "
            "min REAL, max REAL, PRIMARY KEY(id_variable))")
        cur.execute(
            "CREATE TABLE IF NOT EXISTS joint_stations "
            "(id_point TEXT, joint_station TEXT)")
        cur.executemany(
            "INSERT OR IGNORE INTO variable_properties VALUES "
            "(?,?,?,?,?,?,?,?,?)", _VARIABLE_PROPERTIES)
        self.db.commit()

    def _create_data_table(self, table: str, delete_previous: bool = False):
        """createTable (dbMeteoPointsHandler.cpp:1382-1397)."""
        cur = self.db.cursor()
        if delete_previous:
            cur.execute(f"DROP TABLE IF EXISTS '{table}'")
        cur.execute(
            f"CREATE TABLE IF NOT EXISTS `{table}` (date_time TEXT(19), "
            "id_variable INTEGER, value REAL, "
            "PRIMARY KEY(date_time, id_variable))")

    # ------------------------------------------------------------------
    def point_ids(self) -> list[str]:
        return [str(r[0]) for r in self.db.execute(
            "SELECT id_point FROM point_properties")]

    def write_point_properties(self, *, id_point: str, name: str = "",
                               latitude: float = 0.0, longitude: float = 0.0,
                               utm_x: float = 0.0, utm_y: float = 0.0,
                               altitude: float = 0.0, is_active: int = 1,
                               is_utc: int = 1, dataset: str = "",
                               orog_code: float = 0.0) -> None:
        """Upsert a station row (writePointProperties,
        dbMeteoPointsHandler.cpp:1246+)."""
        self.db.execute(
            "INSERT OR REPLACE INTO point_properties (id_point, name, "
            "dataset, latitude, longitude, latInt, lonInt, utm_x, utm_y, "
            "altitude, state, region, province, municipality, is_active, "
            "is_utc, orog_code) VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)",
            (id_point, name or id_point, dataset, latitude, longitude,
             int(latitude * 1e6), int(longitude * 1e6), utm_x, utm_y,
             altitude, "", "", "", "", is_active, is_utc, orog_code))
        self.db.commit()

    # ------------------------------------------------------------------
    def write_hourly(self, point_code: str, var: MeteoVariable,
                     t0: datetime.datetime, values,
                     delete_previous: bool = False) -> int:
        """Insert one hourly series (writeHourlyDataList analogue).
        Returns the number of rows written (NODATA values are skipped)."""
        if point_code not in self.point_ids():
            raise KeyError(f"{point_code} not in point_properties")
        table = f"{point_code}_H"
        self._create_data_table(table, delete_previous)
        id_var = HOURLY_DB_IDS[var]
        rows = []
        for i, v in enumerate(np.asarray(values, dtype=np.float64)):
            if v == NODATA or not np.isfinite(v):
                continue
            ts = t0 + datetime.timedelta(hours=i)
            rows.append((ts.strftime("%Y-%m-%d %H:%M:%S"), id_var, float(v)))
        self.db.executemany(
            f"INSERT OR REPLACE INTO `{table}` VALUES (?,?,?)", rows)
        self.db.commit()
        return len(rows)

    def write_daily(self, point_code: str, var: MeteoVariable,
                    d0: datetime.date, values,
                    delete_previous: bool = False) -> int:
        if point_code not in self.point_ids():
            raise KeyError(f"{point_code} not in point_properties")
        table = f"{point_code}_D"
        self._create_data_table(table, delete_previous)
        id_var = DAILY_DB_IDS[var]
        rows = []
        for i, v in enumerate(np.asarray(values, dtype=np.float64)):
            if v == NODATA or not np.isfinite(v):
                continue
            day = d0 + datetime.timedelta(days=i)
            rows.append((day.strftime("%Y-%m-%d"), id_var, float(v)))
        self.db.executemany(
            f"INSERT OR REPLACE INTO `{table}` VALUES (?,?,?)", rows)
        self.db.commit()
        return len(rows)

    # ------------------------------------------------------------------
    def import_hourly_csv(self, csv_path: str, point_code: str | None = None,
                          delete_previous: bool = True) -> dict:
        """Import the reference's fixed hourly CSV format
        (importHourlyMeteoData, dbMeteoPointsHandler.cpp:1437-1580):
        ``DATE(yyyy-mm-dd), HOUR, TAVG, PREC, RHAVG, RAD, W_SCAL_INT``,
        mandatory header; the point code defaults to the file name (minus an
        optional ``_H`` suffix) and must exist in point_properties.

        Returns import statistics.
        """
        if point_code is None:
            point_code = os.path.splitext(os.path.basename(csv_path))[0]
            if point_code.endswith("_H"):
                point_code = point_code[:-2]
        if point_code not in self.point_ids():
            raise KeyError(
                f"ID {point_code} is not present in point_properties")

        table = f"{point_code}_H"
        self._create_data_table(table, delete_previous)

        n_wrong_dt = n_wrong = n_missing = 0
        rows = []
        prev = None
        with open(csv_path) as f:
            next(f)  # mandatory header
            for line in f:
                parts = [p.strip() for p in line.split(",")]
                if len(parts) <= 2:
                    continue
                try:
                    date = datetime.date.fromisoformat(parts[0])
                    hour = int(parts[1])
                    if not (0 <= hour <= 23):
                        raise ValueError
                except ValueError:
                    n_wrong_dt += 1
                    continue
                key = (date, hour)
                if prev is not None and key <= prev:
                    n_wrong_dt += 1      # duplicate / out of order
                    continue
                prev = key
                ts = f"{date.isoformat()} {hour:02d}:00:00"
                for pos, var in _CSV_COLUMNS:
                    if len(parts) <= pos or parts[pos] == "":
                        n_missing += 1
                        continue
                    try:
                        v = float(parts[pos])
                    except ValueError:
                        n_wrong += 1
                        continue
                    rng = QUALITY_RANGES.get(var)
                    if rng is not None and not (rng.vmin <= v <= rng.vmax):
                        n_wrong += 1
                        continue
                    rows.append((ts, HOURLY_DB_IDS[var], v))
        self.db.executemany(
            f"INSERT OR REPLACE INTO `{table}` VALUES (?,?,?)", rows)
        self.db.commit()
        return dict(point_code=point_code, written=len(rows),
                    wrong_datetime=n_wrong_dt, wrong_data=n_wrong,
                    missing_data=n_missing)

    # ------------------------------------------------------------------
    def read_stations(self, *, load_hourly: bool = True,
                      load_daily: bool = False,
                      t0: datetime.datetime | None = None,
                      t1: datetime.datetime | None = None
                      ) -> list[MeteoStation]:
        """Stations + (optionally) their series as MeteoStation containers
        (loadHourlyData, dbMeteoPointsHandler.cpp:860+). ``t0``/``t1`` clip
        the hourly window; series are dense regular arrays with NODATA gaps.
        """
        cur = self.db.cursor()
        stations = []
        for r in cur.execute(
                "SELECT id_point, name, latitude, longitude, utm_x, utm_y, "
                "altitude, is_active FROM point_properties"):
            stations.append(MeteoStation(
                id=str(r[0]), name=r[1] or str(r[0]),
                latitude=float(r[2] or 0), longitude=float(r[3] or 0),
                utm_x=float(r[4] or NODATA), utm_y=float(r[5] or NODATA),
                altitude=float(r[6] or 0),
                is_active=bool(r[7] if r[7] is not None else 1)))

        tables = {t[0] for t in cur.execute(
            "SELECT name FROM sqlite_master WHERE type='table'")}

        for st in stations:
            if load_hourly and f"{st.id}_H" in tables:
                self._load_hourly(st, t0, t1)
            if load_daily and f"{st.id}_D" in tables:
                self._load_daily(st)
        return stations

    def _load_hourly(self, st: MeteoStation, t0, t1):
        cond, args = "", []
        if t0 is not None:
            cond += " AND date_time >= ?"
            args.append(t0.strftime("%Y-%m-%d %H:%M:%S"))
        if t1 is not None:
            cond += " AND date_time <= ?"
            args.append(t1.strftime("%Y-%m-%d %H:%M:%S"))
        rows = self.db.execute(
            f"SELECT date_time, id_variable, value FROM `{st.id}_H` "
            f"WHERE 1=1{cond} ORDER BY date_time", args).fetchall()
        if not rows:
            return
        parse = lambda s: datetime.datetime.strptime(s[:19],
                                                     "%Y-%m-%d %H:%M:%S")
        start = parse(rows[0][0])
        end = parse(rows[-1][0])
        n = int((end - start).total_seconds() // 3600) + 1
        series: dict[MeteoVariable, np.ndarray] = {}
        for ts, id_var, value in rows:
            var = variable_from_db_id(id_var)
            if var is None or value is None:
                continue
            if var not in series:
                series[var] = np.full(n, NODATA)
            idx = int((parse(ts) - start).total_seconds() // 3600)
            if 0 <= idx < n:
                series[var][idx] = float(value)
        st.hourly_t0 = start
        st.hourly = series

    def _load_daily(self, st: MeteoStation):
        rows = self.db.execute(
            f"SELECT date_time, id_variable, value FROM `{st.id}_D` "
            "ORDER BY date_time").fetchall()
        if not rows:
            return
        parse = lambda s: datetime.date.fromisoformat(s[:10])
        start, end = parse(rows[0][0]), parse(rows[-1][0])
        n = (end - start).days + 1
        series: dict[MeteoVariable, np.ndarray] = {}
        for ts, id_var, value in rows:
            var = variable_from_db_id(id_var)
            if var is None or value is None:
                continue
            if var not in series:
                series[var] = np.full(n, NODATA)
            idx = (parse(ts) - start).days
            if 0 <= idx < n:
                series[var][idx] = float(value)
        st.daily_d0 = start
        st.daily = series


# ----------------------------------------------------------------------
# daily -> hourly synthesis (data preparation helper)
# ----------------------------------------------------------------------

def synthesize_hourly_from_daily(tmin, tmax, prec_mm, d0: datetime.date,
                                 *, latitude: float = 45.0,
                                 longitude: float = 10.0,
                                 samani_coeff: float = 0.17) -> dict:
    """Synthesize hourly series from daily tmin/tmax/precipitation.

    Data-preparation utility (NOT a reference-parity feature): the sample
    project Montue ships only a daily meteo1D DB — its hourly station DB is
    absent from the reference repository — so an hourly DB must be built to
    drive the hourly cycle. Uses the standard disaggregations:

    * temperature: cosine diurnal cycle peaking at 14h with the daily
      amplitude (Parton-Logan simplified);
    * relative humidity: dew point ~ tmin, RH = es(td)/es(T);
    * precipitation: spread uniformly over the 24 hours;
    * global radiation: clear-sky extraterrestrial horizontal profile scaled
      by the Samani transmissivity kt*sqrt(tmax-tmin)
      (transmissivity.cpp:36-46).

    Returns {MeteoVariable: np.ndarray[n_days*24]} plus "t0".
    """
    import torch

    from criteria3d_tpu_torch.physics.radiation import sun_position

    tmin = np.asarray(tmin, dtype=np.float64)
    tmax = np.asarray(tmax, dtype=np.float64)
    prec = np.asarray(prec_mm, dtype=np.float64)
    n_days = len(tmin)
    n = n_days * 24
    hours = np.arange(n) % 24
    days = np.arange(n) // 24

    t_avg = 0.5 * (tmin + tmax)
    t_range = np.maximum(tmax - tmin, 0.0)
    t = t_avg[days] + 0.5 * t_range[days] * np.cos(
        2.0 * np.pi * (hours - 14) / 24.0)

    # RH from dew point ~ tmin (Tetens, consistent with physics/meteo.py)
    es = lambda tc: 611.0 * np.exp(17.502 * tc / (tc + 240.97))
    rh = np.clip(100.0 * es(tmin[days]) / np.maximum(es(t), 1e-9), 5.0, 100.0)

    p = np.where(prec[days] > 0, prec[days] / 24.0, 0.0)

    # radiation: ETR horizontal profile x Samani transmissivity
    trans = np.clip(samani_coeff * np.sqrt(t_range), 0.0, 0.75)
    rad = np.zeros(n)
    for day in range(n_days):
        date = d0 + datetime.timedelta(days=int(day))
        for h in range(24):
            sun = sun_position(torch.tensor(float(latitude), dtype=torch.float64),
                               longitude, 0, date.year, date.month, date.day, h)
            etr = float(sun["etr_horizontal"])
            rad[day * 24 + h] = max(etr, 0.0) * trans[day]

    t0 = datetime.datetime(d0.year, d0.month, d0.day)
    return {"t0": t0,
            MeteoVariable.AIR_TEMPERATURE: t,
            MeteoVariable.AIR_REL_HUMIDITY: rh,
            MeteoVariable.PRECIPITATION: p,
            MeteoVariable.GLOBAL_IRRADIANCE: rad}

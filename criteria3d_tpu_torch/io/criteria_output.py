"""CRITERIA output post-processing (reference: agrolib/criteriaOutput).

The port's own copy of ``criteria3d_tpu/io/criteria_output.py``, line for line (host
numpy and the standard library).

Re-implements the criteriaOutput pipeline (criteriaOutputProject.{h,cpp},
criteriaOutputElaboration.{h,cpp}, criteriaOutputVariable.{h,cpp},
criteriaAggregationVariable.h) on SQLite + numpy:

* variable-list CSV parsing ("output var name, var name, reference day,
  computation, nr days, climate computation, param1, param2" — 8 required
  columns, CSVREQUIREDINFO);
* per-unit daily output DBs: windowed SUM/AVG/MAX/MIN extraction
  (selectSimpleVar), transpiration-deficit indices DT30/DT90/DT180
  (computeAllDtxPeriod / computeDTX) with incomplete-window NODATA
  semantics, persisted back to the unit table (writeDtxToDB);
* per-unit CSV writer (writeCsvOutputUnit) and CSV sort
  (orderCsvByField);
* shapefile step: join the CSV onto a unit-crop-map shapefile and
  aggregate onto region shapes with zonal statistics
  (writeCsvAggrFromShape + zonalStatistic.cpp path).
"""

from __future__ import annotations

import csv as _csv
import dataclasses
import datetime as _dt
import sqlite3

import numpy as np

NODATA = -9999.0

__all__ = [
    "OutputVariableList", "AggregationVariableList", "compute_dtx",
    "compute_all_dtx_unit", "write_dtx_to_db", "select_simple_var",
    "compute_dtx_var", "write_csv_output_unit", "order_csv_by_field",
    "write_csv_aggregation_from_shape", "NODATA",
]


# ------------------------------------------------------- list file parsing

@dataclasses.dataclass
class OutputVariableList:
    """criteriaOutputVariable.cpp parserOutputVariable analogue."""
    output_var_names: list[str]
    var_names: list[str]
    computations: list[str]
    reference_days: list[int]
    nr_days: list[str]
    climate_computations: list[str]
    param1: list[int]
    param2: list[int]

    REQUIRED = ("output var name", "var name", "reference day",
                "computation", "nr days", "climate computation",
                "param1", "param2")

    @classmethod
    def parse(cls, path: str) -> "OutputVariableList":
        with open(path, newline="") as f:
            reader = _csv.reader(f)
            header = [h.strip().lower() for h in next(reader)]
            for col in cls.REQUIRED:
                if col not in header:
                    raise ValueError(f"missing column '{col}' in {path}")
            idx = {c: header.index(c) for c in cls.REQUIRED}
            out = cls([], [], [], [], [], [], [], [])
            for items in reader:
                if len(items) < len(cls.REQUIRED):
                    raise ValueError("invalid output variables CSV: "
                                     "missing reference data")
                out.output_var_names.append(items[idx["output var name"]].strip())
                out.var_names.append(items[idx["var name"]].strip().upper())
                out.reference_days.append(int(items[idx["reference day"]] or 0))
                out.computations.append(items[idx["computation"]].strip().upper())
                out.nr_days.append(items[idx["nr days"]].strip())
                out.climate_computations.append(
                    items[idx["climate computation"]].strip())
                out.param1.append(int(items[idx["param1"]] or 0))
                out.param2.append(int(items[idx["param2"]] or 0))
        return out

    def __len__(self):
        return len(self.var_names)


@dataclasses.dataclass
class AggregationVariableList:
    """criteriaAggregationVariable.h analogue (3 required columns)."""
    output_var_names: list[str]
    input_field_names: list[str]
    aggregation_types: list[str]

    @classmethod
    def parse(cls, path: str) -> "AggregationVariableList":
        with open(path, newline="") as f:
            reader = _csv.reader(f)
            header = [h.strip().lower() for h in next(reader)]
            need = ("output var name", "input field name", "aggregation type")
            for col in need:
                if col not in header:
                    raise ValueError(f"missing column '{col}' in {path}")
            idx = {c: header.index(c) for c in need}
            out = cls([], [], [])
            for items in reader:
                if len(items) < 3:
                    continue
                out.output_var_names.append(items[idx["output var name"]].strip())
                out.input_field_names.append(
                    items[idx["input field name"]].strip())
                out.aggregation_types.append(
                    items[idx["aggregation type"]].strip().upper())
        return out

    def __len__(self):
        return len(self.output_var_names)


# ----------------------------------------------------------------- DTX ---

def compute_dtx(transp_max: np.ndarray, transp_real: np.ndarray,
                period: int) -> np.ndarray:
    """Transpiration-deficit index over a trailing window.

    dailyDt = max(0, TRANSP_MAX - TRANSP); DTX[i] = sum of the last
    `period` daily deficits, NODATA while the window is incomplete or
    contains NODATA (criteriaOutputElaboration.cpp:130-211)."""
    if period <= 0:
        raise ValueError("invalid period: zero")
    tm = np.asarray(transp_max, np.float64)
    tr = np.asarray(transp_real, np.float64)
    bad = np.isclose(tm, NODATA) | np.isclose(tr, NODATA)
    daily = np.where(bad, np.nan, np.maximum(0.0, tm - tr))
    n = daily.size
    dtx = np.full(n, NODATA)
    if n == 0:
        return dtx
    csum = np.concatenate([[0.0], np.nancumsum(daily)])
    cbad = np.concatenate([[0], np.cumsum(bad)])
    for i in range(period - 1, n):
        if cbad[i + 1] - cbad[i + 1 - period] == 0:
            dtx[i] = csum[i + 1] - csum[i + 1 - period]
    return dtx


def compute_all_dtx_unit(db: sqlite3.Connection, id_case: str
                         ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """DT30/DT90/DT180 for one unit table ordered by DATE
    (computeAllDtxUnit). The TR_S column takes precedence over TRANSP when
    present (criteriaOutputElaboration.cpp:141-147)."""
    cols = [r[1] for r in db.execute(f'PRAGMA table_info("{id_case}")')]
    transp_field = "TR_S" if "TR_S" in cols else "TRANSP"
    rows = db.execute(f'SELECT TRANSP_MAX, "{transp_field}" FROM "{id_case}" '
                      "ORDER BY DATE").fetchall()
    if not rows:
        raise ValueError("No data found")
    tm = np.array([NODATA if r[0] is None else r[0] for r in rows])
    tr = np.array([NODATA if r[1] is None else r[1] for r in rows])
    return (compute_dtx(tm, tr, 30), compute_dtx(tm, tr, 90),
            compute_dtx(tm, tr, 180))


def write_dtx_to_db(db: sqlite3.Connection, id_case: str, dt30, dt90, dt180
                    ) -> None:
    """Persist DT30/DT90/DT180 columns next to the daily data
    (writeDtxToDB)."""
    cols = [r[1] for r in db.execute(f'PRAGMA table_info("{id_case}")')]
    for c in ("DT30", "DT90", "DT180"):
        if c not in cols:
            db.execute(f'ALTER TABLE "{id_case}" ADD COLUMN {c} REAL')
    dates = [r[0] for r in db.execute(
        f'SELECT DATE FROM "{id_case}" ORDER BY DATE')]
    for date, a, b, c in zip(dates, dt30, dt90, dt180):
        db.execute(f'UPDATE "{id_case}" SET DT30=?, DT90=?, DT180=? '
                   "WHERE DATE=?", (round(float(a), 1), round(float(b), 1),
                                    round(float(c), 1), date))
    db.commit()


# -------------------------------------------------------------- variables

def select_simple_var(db: sqlite3.Connection, id_case: str, var_name: str,
                      computation: str, first_date: _dt.date,
                      last_date: _dt.date, irri_ratio: float = 1.0
                      ) -> list[float]:
    """Windowed extraction of one daily variable (selectSimpleVar).

    Empty computation returns the daily values; SUM/AVG/MAX/MIN reduce the
    window to one value. IRRIGATION is scaled by irri_ratio."""
    rows = db.execute(
        f'SELECT "{var_name}" FROM "{id_case}" WHERE DATE >= ? AND DATE <= ? '
        "ORDER BY DATE",
        (first_date.isoformat(), last_date.isoformat())).fetchall()
    values = [NODATA if r[0] is None else float(r[0]) for r in rows]
    if var_name.upper() == "IRRIGATION":
        values = [v * irri_ratio if not np.isclose(v, NODATA) else v
                  for v in values]
    if not computation:
        return values
    if not values:
        return [NODATA]
    arr = np.array(values)
    good = arr[~np.isclose(arr, NODATA)]
    if good.size == 0:
        return [NODATA]
    if computation == "SUM":
        return [float(arr.sum())]                  # reference sums raw values
    if computation == "AVG":
        return [float(arr.sum() / arr.size)]
    if computation == "MAX":
        return [float(arr.max())]
    if computation == "MIN":
        return [float(arr.min())]
    raise ValueError(f"unknown computation {computation}")


def compute_dtx_var(db: sqlite3.Connection, id_case: str, period: int,
                    computation: str, first_date: _dt.date,
                    last_date: _dt.date) -> list[float]:
    """On-the-fly DTX over [first_date, last_date] (computeDTX): for each
    day, deficit summed over the trailing `period` days; then the optional
    SUM/AVG/MAX/MIN reduction."""
    dtx = []
    end = first_date
    while end <= last_date:
        start = end - _dt.timedelta(days=period - 1)
        row = db.execute(
            f'SELECT COUNT(TRANSP_MAX), COUNT(TRANSP), SUM(TRANSP_MAX), '
            f'SUM(TRANSP) FROM "{id_case}" WHERE DATE >= ? AND DATE <= ?',
            (start.isoformat(), end.isoformat())).fetchone()
        if row[0] + row[1] < period * 2:
            dtx.append(NODATA)
        else:
            dtx.append(float(row[2]) - float(row[3]))
        end += _dt.timedelta(days=1)
    if not computation:
        return dtx
    arr = np.array(dtx)
    if computation == "SUM":
        return [float(arr.sum())]
    if computation == "AVG":
        return [float(arr.mean())]
    if computation == "MAX":
        return [float(arr.max())]
    if computation == "MIN":
        return [float(arr.min())]
    raise ValueError(f"unknown computation {computation}")


# -------------------------------------------------------------- CSV steps

def write_csv_output_unit(id_case: str, id_crop: str,
                          db: sqlite3.Connection,
                          date_computation: _dt.date,
                          variables: OutputVariableList,
                          csv_path: str, irri_ratio: float = 1.0) -> int:
    """One CSV row per unit: date, id_case, crop, then each output
    variable evaluated on its window (writeCsvOutputUnit). Returns number
    of missing values."""
    import os
    header_needed = not (os.path.exists(csv_path)
                         and os.path.getsize(csv_path) > 0)
    missing = 0
    row = [date_computation.isoformat(), id_case, id_crop]
    for i, var in enumerate(variables.var_names):
        ref_day = variables.reference_days[i]
        nr_days = variables.nr_days[i]
        first = date_computation + _dt.timedelta(days=ref_day)
        if nr_days.upper() == "YTD":        # since start of year
            first = _dt.date(date_computation.year, 1, 1)
            last = date_computation
        else:
            span = int(nr_days or 1)
            last = first + _dt.timedelta(days=max(span - 1, 0))
        comp = variables.computations[i]
        if var.startswith("DT") and var[2:].isdigit():
            vals = compute_dtx_var(db, id_case, int(var[2:]), comp,
                                   first, last)
        else:
            vals = select_simple_var(db, id_case, var, comp, first, last,
                                     irri_ratio)
        v = vals[0] if vals else NODATA
        if np.isclose(v, NODATA):
            missing += 1
            row.append(str(int(NODATA)))
        else:
            row.append(f"{v:.1f}")
    with open(csv_path, "a", newline="") as f:
        w = _csv.writer(f)
        if header_needed:
            w.writerow(["DATE", "ID_CASE", "CROP"] + variables.output_var_names)
        w.writerow(row)
    return missing


def order_csv_by_field(csv_path: str, field: str) -> None:
    """Stable sort of a CSV by one column (orderCsvByField)."""
    with open(csv_path, newline="") as f:
        reader = _csv.reader(f)
        header = next(reader)
        rows = list(reader)
    idx = header.index(field)
    rows.sort(key=lambda r: r[idx])
    with open(csv_path, "w", newline="") as f:
        w = _csv.writer(f)
        w.writerow(header)
        w.writerows(rows)


def write_csv_aggregation_from_shape(handler, csv_path: str,
                                     date_computation: _dt.date,
                                     shape_var_names: list[str],
                                     output_var_names: list[str],
                                     shape_field: str) -> int:
    """Dump per-shape aggregated attributes to CSV
    (writeCsvAggrFromShape): one row per shape record — date, zone id,
    then each aggregated variable. Returns rows written."""
    rows = []
    for i in range(handler.shape_count):
        if handler.deleted[i]:
            continue
        zone = handler.get_string_value(i, shape_field) or \
            str(handler.get_numeric_value(i, shape_field))
        row = [date_computation.isoformat(), zone]
        for var in shape_var_names:
            v = handler.get_numeric_value(i, var)
            row.append(str(int(NODATA)) if not np.isfinite(v) else f"{v:.2f}")
        rows.append(row)
    with open(csv_path, "w", newline="") as f:
        w = _csv.writer(f)
        w.writerow(["DATE", "ZONE ID"] + list(output_var_names))
        w.writerows(rows)
    return len(rows)

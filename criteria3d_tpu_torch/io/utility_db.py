"""Small utility SQLite DBs: water-table parameters and computation units.

The port's own copy of ``criteria3d_tpu/io/utility_db.py``, line for line (host
numpy and the standard library). The water-table model is
the port's ``physics/watertable.WaterTableModel``.

Mirrors the last two agrolib/utilities components (SURVEY §2.2 row 19):

* ``waterTableDb`` (waterTableDb.{h,cpp}) — persisted PRE-FITTED
  water-table CWB models: one ``wellProperties`` row per well with
  (ID_WATERTABLE, lat, lon, alpha, h0, avgDailyCWB, nrDays). CRITERIA-1D
  reads these instead of re-fitting; here they round-trip
  :class:`criteria3d_tpu_torch.physics.watertable.WaterTableModel`.
* ``computationUnitsDb`` (computationUnitsDb.{h,cpp}) — the CRITERIA-1D
  ``computational_units`` table mapping a case id to its crop / meteo /
  soil / water-table ids and area (consumed by the criteriaOutput
  post-processing chain, io/criteria_output.py).
"""

from __future__ import annotations

import dataclasses
import sqlite3

from criteria3d_tpu_torch.constants import NODATA
from criteria3d_tpu_torch.physics.watertable import WaterTableModel

__all__ = ["WaterTableParamsDb", "ComputationUnit", "ComputationUnitsDb"]


class WaterTableParamsDb:
    """wellProperties reader/writer (WaterTableDb, waterTableDb.cpp:55-92)."""

    def __init__(self, path: str):
        self.path = path

    def write(self, well_id: str, model: WaterTableModel,
              lat: float = NODATA, lon: float = NODATA) -> None:
        con = sqlite3.connect(self.path)
        con.execute(
            "CREATE TABLE IF NOT EXISTS wellProperties ("
            "ID_WATERTABLE TEXT PRIMARY KEY, lat REAL, lon REAL, "
            "alpha REAL, h0 REAL, avgDailyCWB REAL, nrDays INTEGER)")
        con.execute(
            "INSERT OR REPLACE INTO wellProperties VALUES (?,?,?,?,?,?,?)",
            (well_id, float(lat), float(lon), float(model.alpha),
             float(model.h0), float(model.avg_daily_cwb),
             int(model.nr_days)))
        con.commit()
        con.close()

    def read(self, well_id: str) -> tuple[WaterTableModel, float, float]:
        """(model, lat, lon); raises KeyError on a missing id
        (readSingleWaterTableParameters error path)."""
        con = sqlite3.connect(f"file:{self.path}?mode=ro", uri=True)
        row = con.execute(
            "SELECT lat, lon, alpha, h0, avgDailyCWB, nrDays "
            "FROM wellProperties WHERE ID_WATERTABLE=?",
            (well_id,)).fetchone()
        con.close()
        if row is None:
            raise KeyError(
                f"Missing waterTable ID in wellProperties table: {well_id}")
        lat, lon, alpha, h0, cwb, nr_days = row
        model = WaterTableModel(h0=h0, alpha=alpha, nr_days=int(nr_days),
                                avg_daily_cwb=cwb, r2=1.0)
        return model, lat, lon


@dataclasses.dataclass
class ComputationUnit:
    """One computational_units row (Crit1DCompUnit subset,
    computationUnitsDb.h)."""

    id_case: str
    id_crop: str = ""
    id_meteo: str = ""
    id_soil: str = ""
    id_water_table: str = ""
    hectares: float = 0.0
    use_water_table: bool = False
    numerical_solution: bool = False


class ComputationUnitsDb:
    """computational_units reader/writer
    (ComputationUnitsDB::writeListToCompUnitsTable / readUnitList,
    computationUnitsDb.cpp:59-200)."""

    def __init__(self, path: str):
        self.path = path

    def write_units(self, units: list) -> None:
        con = sqlite3.connect(self.path)
        con.execute(
            "CREATE TABLE IF NOT EXISTS computational_units ("
            "ID_CASE TEXT PRIMARY KEY, ID_CROP TEXT, ID_METEO TEXT, "
            "ID_SOIL TEXT, ID_WATERTABLE TEXT, HECTARES NUMERIC, "
            "use_water_table INTEGER DEFAULT 1, "
            "numerical_solution INTEGER DEFAULT 0)")
        con.executemany(
            "INSERT OR REPLACE INTO computational_units VALUES "
            "(?,?,?,?,?,?,?,?)",
            [(u.id_case, u.id_crop, u.id_meteo, u.id_soil,
              u.id_water_table, float(u.hectares),
              1 if u.use_water_table else 0,
              1 if u.numerical_solution else 0) for u in units])
        con.commit()
        con.close()

    def read_units(self) -> list:
        con = sqlite3.connect(f"file:{self.path}?mode=ro", uri=True)
        rows = con.execute(
            "SELECT ID_CASE, ID_CROP, ID_METEO, ID_SOIL, ID_WATERTABLE, "
            "HECTARES, use_water_table, numerical_solution "
            "FROM computational_units ORDER BY ID_CASE").fetchall()
        con.close()
        return [ComputationUnit(
            id_case=r[0], id_crop=r[1] or "", id_meteo=r[2] or "",
            id_soil=r[3] or "", id_water_table=r[4] or "",
            hectares=float(r[5] or 0.0),
            use_water_table=bool(r[6]), numerical_solution=bool(r[7]))
            for r in rows]

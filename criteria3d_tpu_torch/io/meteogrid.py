"""Meteo grid database: XML-described gridded weather storage.

The port's own copy of ``criteria3d_tpu/io/meteogrid.py``, line for line
(host numpy and sqlite3): the grid cells become the port's
``core.meteo.MeteoStation``s, so the project's QC and interpolation run
from them on the grid's device unchanged.

Re-implements the structure of agrolib/dbMeteoGrid (Crit3DMeteoGridDbHandler):
an XML file describes the grid geometry (GridStructure/XLL/YLL/NrRows/NrCols/
XWidth/YWidth) and the per-cell table naming scheme (TableDaily/TableHourly
prefix/postfix + VarCode list); the data live in one SQL table per grid cell.

The reference targets MySQL (ARPAE's operational grid) with SQLite also
possible through Qt SQL; here SQLite is the backend (MySQL is site
infrastructure, not model capability).
"""

from __future__ import annotations

import dataclasses
import sqlite3
import xml.etree.ElementTree as ET

import numpy as np

from criteria3d_tpu_torch.constants import NODATA

__all__ = ["MeteoGridStructure", "MeteoGridDb", "GridCell", "parse_grid_xml",
           "cell_center", "aggregate_raster_to_grid",
           "stations_from_grid"]

# reference: GRID_MIN_COVERAGE 10% (commonConstants.h) — minimum share of
# valid DEM cells inside a grid cell for the aggregate to count
GRID_MIN_COVERAGE = 0.1


@dataclasses.dataclass
class GridCell:
    """One CellsProperties row (dbMeteoGrid.cpp:1214-1306 loadCellProperties,
    :1306-1340 newCellProperties)."""

    code: str
    row: int
    col: int
    name: str = ""
    height: float = NODATA
    active: bool = True


def cell_center(structure: MeteoGridStructure, row: int, col: int
                ) -> tuple[float, float]:
    """(x, y) centre of a grid cell; row 0 is the SOUTH row (the XLL/YLL
    corner convention of the XML, dbMeteoGrid.cpp:169-320)."""
    x = structure.ll_longitude + (col + 0.5) * structure.dx
    y = structure.ll_latitude + (row + 0.5) * structure.dy
    return x, y


@dataclasses.dataclass
class MeteoGridStructure:
    """GridStructure section of the XML (dbMeteoGrid.cpp:169-320)."""

    is_regular: bool = True
    is_utm: bool = False
    nr_rows: int = 0
    nr_cols: int = 0
    ll_longitude: float = 0.0
    ll_latitude: float = 0.0
    dx: float = 0.0
    dy: float = 0.0
    # table naming
    daily_prefix: str = ""
    daily_postfix: str = "_D"
    hourly_prefix: str = ""
    hourly_postfix: str = "_H"
    daily_field_time: str = "PragaTime"
    hourly_field_time: str = "PragaTime"
    daily_varcodes: dict = dataclasses.field(default_factory=dict)
    hourly_varcodes: dict = dataclasses.field(default_factory=dict)


def parse_grid_xml(path: str) -> MeteoGridStructure:
    """Parse the XML description (loadCellProperties-style schema)."""
    tree = ET.parse(path)
    root = tree.getroot()
    s = MeteoGridStructure()

    for node in root:
        tag = node.tag.upper()
        if tag == "GRIDSTRUCTURE":
            s.is_regular = node.attrib.get("isregular", "true").lower() == "true"
            s.is_utm = node.attrib.get("isutm", "false").lower() == "true"
            for child in node.iter():
                t = child.tag.upper()
                text = (child.text or "").strip()
                if t == "XLL":
                    s.ll_longitude = float(text)
                elif t == "YLL":
                    s.ll_latitude = float(text)
                elif t in ("NROWS", "NRROWS"):
                    s.nr_rows = int(text)
                elif t in ("NCOLS", "NRCOLS"):
                    s.nr_cols = int(text)
                elif t == "XWIDTH":
                    s.dx = float(text)
                elif t == "YWIDTH":
                    s.dy = float(text)
        elif tag in ("TABLEDAILY", "TABLEHOURLY"):
            daily = tag == "TABLEDAILY"
            for child in node:
                t = child.tag.upper()
                text = (child.text or "").strip()
                if t == "FIELDTIME":
                    if daily:
                        s.daily_field_time = text
                    else:
                        s.hourly_field_time = text
                elif t == "PREFIX":
                    if daily:
                        s.daily_prefix = text
                    else:
                        s.hourly_prefix = text
                elif t == "POSTFIX":
                    if daily:
                        s.daily_postfix = text
                    else:
                        s.hourly_postfix = text
                elif t == "VARCODE":
                    varname, code = None, None
                    for vc in child:
                        if vc.tag.upper() == "VARFIELD":
                            varname = (vc.text or "").strip()
                        elif vc.tag.upper() == "VARCODE":
                            code = (vc.text or "").strip()
                    if varname:
                        if daily:
                            s.daily_varcodes[varname] = code
                        else:
                            s.hourly_varcodes[varname] = code
    return s


class MeteoGridDb:
    """Reader/writer for the per-cell table layout."""

    def __init__(self, db_path: str, structure: MeteoGridStructure):
        self.path = db_path
        self.structure = structure

    def _table(self, cell_code: str, daily: bool) -> str:
        s = self.structure
        if daily:
            return f"{s.daily_prefix}{cell_code}{s.daily_postfix}"
        return f"{s.hourly_prefix}{cell_code}{s.hourly_postfix}"

    def write_daily(self, cell_code: str, dates, values: dict) -> None:
        con = sqlite3.connect(self.path)
        cur = con.cursor()
        table = self._table(cell_code, daily=True)
        cols = list(values.keys())
        cur.execute(
            f'CREATE TABLE IF NOT EXISTS "{table}" '
            f'({self.structure.daily_field_time} TEXT PRIMARY KEY, '
            + ", ".join(f'"{c}" REAL' for c in cols) + ")")
        for i, d in enumerate(dates):
            cur.execute(
                f'INSERT OR REPLACE INTO "{table}" VALUES (?'
                + ", ?" * len(cols) + ")",
                [str(d)] + [float(values[c][i]) for c in cols])
        con.commit()
        con.close()

    def read_daily(self, cell_code: str, variable: str) -> tuple:
        """(dates, values) for one variable of one cell."""
        con = sqlite3.connect(f"file:{self.path}?mode=ro", uri=True)
        cur = con.cursor()
        table = self._table(cell_code, daily=True)
        ft = self.structure.daily_field_time
        try:
            rows = cur.execute(
                f'SELECT {ft}, "{variable}" FROM "{table}" ORDER BY {ft}'
            ).fetchall()
        except sqlite3.OperationalError:
            con.close()
            return [], np.array([])
        con.close()
        dates = [r[0] for r in rows]
        vals = np.array([r[1] if r[1] is not None else NODATA for r in rows])
        return dates, vals

    # --- cell properties (CellsProperties; dbMeteoGrid.cpp:1214-1340) ----

    def write_cell_properties(self, cells: list) -> None:
        con = sqlite3.connect(self.path)
        cur = con.cursor()
        cur.execute(
            "CREATE TABLE IF NOT EXISTS CellsProperties "
            "(Code TEXT NOT NULL PRIMARY KEY, Name TEXT, Row INTEGER, "
            "Col INTEGER, Height REAL, Active INTEGER)")
        for c in cells:
            cur.execute(
                "INSERT OR REPLACE INTO CellsProperties VALUES (?,?,?,?,?,?)",
                (c.code, c.name or c.code, int(c.row), int(c.col),
                 float(c.height), 1 if c.active else 0))
        con.commit()
        con.close()

    def load_cell_properties(self) -> list:
        """All CellsProperties rows ordered by Code
        (loadCellProperties, dbMeteoGrid.cpp:1214-1306)."""
        con = sqlite3.connect(f"file:{self.path}?mode=ro", uri=True)
        cur = con.cursor()
        try:
            rows = cur.execute(
                "SELECT Code, Name, Row, Col, Height, Active "
                "FROM CellsProperties ORDER BY Code").fetchall()
        except sqlite3.OperationalError:
            con.close()
            return []
        con.close()
        out = []
        for code, name, row, col, height, active in rows:
            if row >= self.structure.nr_rows or col >= self.structure.nr_cols:
                raise ValueError(
                    f"CellsProperties: cell {code} at ({row},{col}) outside "
                    f"the {self.structure.nr_rows}x{self.structure.nr_cols} "
                    "grid")
            out.append(GridCell(code=str(code), name=name or str(code),
                                row=int(row), col=int(col),
                                height=NODATA if height is None else float(height),
                                active=bool(active)))
        return out

    def cell_codes_2d(self, cells: list | None = None) -> np.ndarray:
        """(nr_rows, nr_cols) object array of cell codes ('' = no cell)."""
        if cells is None:
            cells = self.load_cell_properties()
        out = np.full((self.structure.nr_rows, self.structure.nr_cols), "",
                      dtype=object)
        for c in cells:
            out[c.row, c.col] = c.code
        return out

    # --- hourly tables: long format (PragaTime, VariableCode, Value) -----
    # (the reference's default non-fixed-fields layout,
    #  loadGridHourlyData dbMeteoGrid.cpp:1699-1770)

    def write_hourly(self, cell_code: str, times, varcode_values: dict
                     ) -> None:
        """``varcode_values`` maps an int VariableCode to a series aligned
        with ``times`` (datetime-like or ISO strings)."""
        con = sqlite3.connect(self.path)
        cur = con.cursor()
        table = self._table(cell_code, daily=False)
        ft = self.structure.hourly_field_time
        cur.execute(
            f'CREATE TABLE IF NOT EXISTS "{table}" '
            f"({ft} TEXT, VariableCode INTEGER, Value REAL, "
            f"PRIMARY KEY ({ft}, VariableCode))")
        for code, series in varcode_values.items():
            for t, v in zip(times, series):
                cur.execute(
                    f'INSERT OR REPLACE INTO "{table}" VALUES (?,?,?)',
                    (_time_str(t), int(code), float(v)))
        con.commit()
        con.close()

    def read_hourly(self, cell_code: str, varcode: int) -> tuple:
        """(times, values) of one VariableCode for one cell."""
        con = sqlite3.connect(f"file:{self.path}?mode=ro", uri=True)
        cur = con.cursor()
        table = self._table(cell_code, daily=False)
        ft = self.structure.hourly_field_time
        try:
            rows = cur.execute(
                f'SELECT {ft}, Value FROM "{table}" '
                f"WHERE VariableCode=? ORDER BY {ft}",
                (int(varcode),)).fetchall()
        except sqlite3.OperationalError:
            con.close()
            return [], np.array([])
        con.close()
        times = [r[0] for r in rows]
        vals = np.array([r[1] if r[1] is not None else NODATA for r in rows])
        return times, vals

    def read_hourly_map(self, cell_codes_2d, varcode: int, when) -> np.ndarray:
        """(nr_rows, nr_cols) map of one VariableCode at one time."""
        con = sqlite3.connect(f"file:{self.path}?mode=ro", uri=True)
        cur = con.cursor()
        out = np.full(np.shape(cell_codes_2d), NODATA)
        ft = self.structure.hourly_field_time
        ts = _time_str(when)
        for (r, c), code in np.ndenumerate(np.asarray(cell_codes_2d, object)):
            if not code:
                continue
            table = self._table(str(code), daily=False)
            try:
                row = cur.execute(
                    f'SELECT Value FROM "{table}" '
                    f"WHERE {ft}=? AND VariableCode=?",
                    (ts, int(varcode))).fetchone()
            except sqlite3.OperationalError:
                continue
            if row and row[0] is not None:
                out[r, c] = row[0]
        con.close()
        return out

    def write_hourly_map(self, cells: list, varcode: int, when,
                         grid_values: np.ndarray) -> None:
        """One (nr_rows, nr_cols) aggregated map into the per-cell tables
        (the save side of spatialAggregateMeteoGrid +
        saveCellCurrentGridHourly)."""
        grid_values = np.asarray(grid_values)
        con = sqlite3.connect(self.path)
        cur = con.cursor()
        ft = self.structure.hourly_field_time
        ts = _time_str(when)
        for c in cells:
            if not c.active:
                continue
            v = grid_values[c.row, c.col]
            if np.isclose(v, NODATA):
                continue
            table = self._table(c.code, daily=False)
            cur.execute(
                f'CREATE TABLE IF NOT EXISTS "{table}" '
                f"({ft} TEXT, VariableCode INTEGER, Value REAL, "
                f"PRIMARY KEY ({ft}, VariableCode))")
            cur.execute(
                f'INSERT OR REPLACE INTO "{table}" VALUES (?,?,?)',
                (ts, int(varcode), float(v)))
        con.commit()
        con.close()

    def read_daily_map(self, cell_codes_2d, variable: str, date: str
                       ) -> np.ndarray:
        """(nr_rows, nr_cols) map of one variable at one date; NODATA gaps."""
        con = sqlite3.connect(f"file:{self.path}?mode=ro", uri=True)
        cur = con.cursor()
        out = np.full(np.shape(cell_codes_2d), NODATA)
        ft = self.structure.daily_field_time
        for (r, c), code in np.ndenumerate(np.asarray(cell_codes_2d, object)):
            table = self._table(str(code), daily=True)
            try:
                row = cur.execute(
                    f'SELECT "{variable}" FROM "{table}" WHERE {ft}=?',
                    (date,)).fetchone()
            except sqlite3.OperationalError:
                continue
            if row and row[0] is not None:
                out[r, c] = row[0]
        con.close()
        return out


def _time_str(t) -> str:
    """Canonical 'yyyy-MM-dd HH:mm' key (the reference's PragaTime format,
    dbMeteoGrid.cpp:1725 toString("yyyy-MM-dd hh:mm"))."""
    if isinstance(t, str):
        return t
    return t.strftime("%Y-%m-%d %H:%M")


def aggregate_raster_to_grid(values: np.ndarray, header,
                             structure: MeteoGridStructure,
                             method: str = "average",
                             min_coverage: float = GRID_MIN_COVERAGE
                             ) -> np.ndarray:
    """Aggregate a DEM-resolution raster onto the meteo grid cells.

    The vectorised analogue of Crit3DMeteoGrid::spatialAggregateMeteoGrid
    (meteoGrid.cpp:139 + spatialAggregateMeteoGridPoint): every valid raster
    cell whose centre falls inside a grid cell contributes; a grid cell
    whose valid-coverage share is below ``min_coverage`` (GRID_MIN_COVERAGE)
    gets NODATA. Methods mirror the reference's aggregationMethod enum
    (statistics.h:21): average / median / min / max / sum / std / 95perc.

    ``header`` is the raster's RasterHeader (xllcorner/yllcorner/cellsize).
    Returns (nr_rows, nr_cols) with row 0 = south.
    """
    values = np.asarray(values, dtype=np.float64)
    R, C = values.shape
    cs = header.cellsize
    # raster cell centres (raster row 0 = NORTH row, ESRI convention)
    xs = header.xllcorner + (np.arange(C) + 0.5) * cs
    ys = header.yllcorner + (R - 0.5 - np.arange(R)) * cs
    gx = np.floor((xs - structure.ll_longitude) / structure.dx).astype(int)
    gy = np.floor((ys - structure.ll_latitude) / structure.dy).astype(int)
    gcol = np.broadcast_to(gx[None, :], (R, C))
    grow = np.broadcast_to(gy[:, None], (R, C))
    valid = ~np.isclose(values, NODATA) & np.isfinite(values)
    inside = ((gcol >= 0) & (gcol < structure.nr_cols)
              & (grow >= 0) & (grow < structure.nr_rows))

    out = np.full((structure.nr_rows, structure.nr_cols), NODATA)
    sel_any = inside
    flat_idx = grow * structure.nr_cols + gcol
    n_inside = np.bincount(flat_idx[sel_any],
                           minlength=structure.nr_rows * structure.nr_cols)
    sel = inside & valid
    n_valid = np.bincount(flat_idx[sel],
                          minlength=structure.nr_rows * structure.nr_cols)

    if method in ("average", "sum", "std"):
        s1 = np.bincount(flat_idx[sel], weights=values[sel],
                         minlength=n_inside.size)
        with np.errstate(invalid="ignore", divide="ignore"):
            mean = s1 / n_valid
        if method == "sum":
            agg = s1
        elif method == "average":
            agg = mean
        else:
            s2 = np.bincount(flat_idx[sel], weights=values[sel] ** 2,
                             minlength=n_inside.size)
            with np.errstate(invalid="ignore", divide="ignore"):
                agg = np.sqrt(np.maximum(s2 / n_valid - mean ** 2, 0.0))
        agg = agg.reshape(structure.nr_rows, structure.nr_cols)
    else:
        # order-statistic methods need the value lists
        agg = np.full((structure.nr_rows, structure.nr_cols), NODATA)
        order = np.argsort(flat_idx[sel], kind="stable")
        vals_sorted = values[sel][order]
        idx_sorted = flat_idx[sel][order]
        bounds = np.searchsorted(idx_sorted,
                                 np.arange(n_inside.size + 1))
        fns = {"median": np.median, "min": np.min, "max": np.max,
               "95perc": lambda v: np.percentile(v, 95)}
        if method not in fns:
            raise ValueError(f"unknown aggregation method: {method}")
        fn = fns[method]
        for cell in np.nonzero(n_valid)[0]:
            v = vals_sorted[bounds[cell]:bounds[cell + 1]]
            agg.flat[cell] = fn(v)
        agg = agg.reshape(structure.nr_rows, structure.nr_cols)

    n_inside2 = n_inside.reshape(structure.nr_rows, structure.nr_cols)
    n_valid2 = n_valid.reshape(structure.nr_rows, structure.nr_cols)
    with np.errstate(invalid="ignore", divide="ignore"):
        coverage = np.where(n_inside2 > 0, n_valid2 / n_inside2, 0.0)
    return np.where((n_valid2 > 0) & (coverage > min_coverage), agg, NODATA)


def stations_from_grid(db: MeteoGridDb, cells: list | None = None,
                       var_map: dict | None = None,
                       utm_zone: int | None = None) -> list:
    """Active grid cells as virtual meteo stations with their hourly series.

    The reference models grid cells AS Crit3DMeteoPoint objects
    (meteoGrid.cpp fillMeteoPoint; the per-row load loop
    project.cpp:1699-1770), so the whole station pipeline — QC, detrending,
    interpolation onto the DEM — drives from a grid DB unchanged. Here the
    same move: each active cell becomes a
    :class:`criteria3d_tpu_torch.core.meteo.MeteoStation` at the cell centre
    with the CellsProperties height.

    ``var_map`` maps VariableCode -> MeteoVariable; defaults to the
    reference template ids (HOURLY_DB_IDS).
    """
    import datetime

    from criteria3d_tpu_torch.core.meteo import HOURLY_DB_IDS, MeteoStation

    if cells is None:
        cells = db.load_cell_properties()
    if var_map is None:
        var_map = {code: var for var, code in HOURLY_DB_IDS.items()}

    stations = []
    for c in cells:
        if not c.active:
            continue
        x, y = cell_center(db.structure, c.row, c.col)
        if db.structure.is_utm:
            utm_x, utm_y = x, y
            lat, lon = y, x  # geographic coords unknown without a zone
            if utm_zone is not None:
                from criteria3d_tpu_torch.core.geo import utm_to_latlon
                lat, lon = utm_to_latlon(utm_zone, 45.0, x, y)
                lat, lon = float(lat), float(lon)
        else:
            # lat-lon grid: station distances/weights must be metric, so
            # project the cell centre to UTM (never mix degrees with
            # metres). Zone from the project, else derived from longitude.
            from criteria3d_tpu_torch.core.geo import latlon_to_utm
            lat, lon = y, x
            zone = utm_zone if utm_zone is not None \
                else int((lon + 180.0) // 6.0) + 1
            e, n, _ = latlon_to_utm(lat, lon, zone)
            utm_x, utm_y = float(e), float(n)
        st = MeteoStation(
            id=c.code, name=c.name or c.code,
            latitude=lat, longitude=lon, utm_x=utm_x, utm_y=utm_y,
            altitude=0.0 if c.height == NODATA else float(c.height))
        for code, var in var_map.items():
            times, vals = db.read_hourly(c.code, code)
            if not times:
                continue
            t0 = datetime.datetime.strptime(times[0], "%Y-%m-%d %H:%M")
            # densify onto a regular hourly axis from t0
            t_end = datetime.datetime.strptime(times[-1], "%Y-%m-%d %H:%M")
            n = int((t_end - t0).total_seconds() // 3600) + 1
            series = np.full(n, NODATA)
            for t, v in zip(times, vals):
                tt = datetime.datetime.strptime(t, "%Y-%m-%d %H:%M")
                i = int((tt - t0).total_seconds() // 3600)
                if 0 <= i < n:
                    series[i] = v
            st.set_hourly(var, t0, series)
        stations.append(st)
    return stations

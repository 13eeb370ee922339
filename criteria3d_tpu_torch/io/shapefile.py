"""ESRI shapefile (.shp/.shx/.dbf) reader/writer — pure numpy/stdlib.

The port's own copy of ``criteria3d_tpu/io/shapefile.py``, line for line (host
numpy and the standard library).

Analogue of the reference's shapelib-based handler
(agrolib/shapeHandler/shapeHandler.{h,cpp}, shapeObject.{h,cpp}): same
capabilities — open/read/write shapefiles, typed DBF attribute access,
add/remove fields, deleted-record handling and repacking, point-in-shape
lookup, hole detection — implemented from the public shapefile / dBase III
specifications rather than through shapelib.

Geometry is stored as numpy vertex arrays so downstream rasterization and
zonal statistics (shape_utils.py) are vectorized.
"""

from __future__ import annotations

import dataclasses
import os
import struct

import numpy as np

__all__ = ["ShapeObject", "DbfField", "ShapeHandler",
           "NULL", "POINT", "POLYLINE", "POLYGON", "MULTIPOINT"]

NULL, POINT, POLYLINE, POLYGON, MULTIPOINT = 0, 1, 3, 5, 8
# Z/M variants carry extra coordinate blocks after the XY payload; we read
# the XY part and expose the base type (shapeObject.cpp treats them alike).
_BASE_TYPE = {0: NULL, 1: POINT, 3: POLYLINE, 5: POLYGON, 8: MULTIPOINT,
              11: POINT, 13: POLYLINE, 15: POLYGON, 18: MULTIPOINT,
              21: POINT, 23: POLYLINE, 25: POLYGON, 28: MULTIPOINT}
_TYPE_NAME = {NULL: "NULL", POINT: "POINT", POLYLINE: "ARC",
              POLYGON: "POLYGON", MULTIPOINT: "MULTIPOINT"}


@dataclasses.dataclass
class DbfField:
    """dBase III field descriptor. ftype: C=string, N/F=numeric, L=logical,
    D=date (stored as string)."""
    name: str
    ftype: str
    width: int
    decimals: int = 0


class ShapeObject:
    """One shapefile record's geometry (shapeObject.h analogue).

    parts: list of (k, 2) float64 vertex arrays (rings for polygons).
    For polygons, ring orientation marks holes: outer rings are clockwise
    in shapefile convention (counter-clockwise signed area < 0 in y-up
    coordinates), holes counter-clockwise.
    """

    def __init__(self, shape_type: int, parts: list[np.ndarray]):
        self.shape_type = int(shape_type)
        self.parts = [np.atleast_2d(np.asarray(p, np.float64)) for p in parts]

    @property
    def bounds(self) -> tuple[float, float, float, float]:
        if not self.parts:
            return (0.0, 0.0, 0.0, 0.0)
        allv = np.vstack(self.parts)
        return (allv[:, 0].min(), allv[:, 1].min(),
                allv[:, 0].max(), allv[:, 1].max())

    @property
    def vertex_count(self) -> int:
        return sum(len(p) for p in self.parts)

    def is_hole(self, part: int) -> bool:
        """Counter-clockwise rings are holes (shapefile spec: outer rings
        clockwise). Matches Crit3DShapeHandler hole bookkeeping."""
        if self.shape_type != POLYGON:
            return False
        return _signed_area(self.parts[part]) > 0.0

    def contains(self, x: float, y: float) -> bool:
        """Even-odd point-in-polygon over all rings (holes cancel)."""
        if self.shape_type != POLYGON:
            return False
        inside = False
        for ring in self.parts:
            if _point_in_ring(x, y, ring):
                inside = not inside
        return inside


def _signed_area(ring: np.ndarray) -> float:
    x, y = ring[:, 0], ring[:, 1]
    return 0.5 * float(np.sum(x * np.roll(y, -1) - np.roll(x, -1) * y))


def _point_in_ring(x: float, y: float, ring: np.ndarray) -> bool:
    x1, y1 = ring[:, 0], ring[:, 1]
    x2, y2 = np.roll(x1, -1), np.roll(y1, -1)
    crosses = (y1 > y) != (y2 > y)
    with np.errstate(divide="ignore", invalid="ignore"):
        xint = x1 + (y - y1) / (y2 - y1) * (x2 - x1)
    return bool(np.count_nonzero(crosses & (x < xint)) % 2)


# ---------------------------------------------------------------- DBF IO --

def _read_dbf(path: str) -> tuple[list[DbfField], list[dict], list[bool]]:
    with open(path, "rb") as f:
        header = f.read(32)
        n_records = struct.unpack("<I", header[4:8])[0]
        header_size, record_size = struct.unpack("<HH", header[8:12])
        fields = []
        while True:
            desc = f.read(1)
            if desc in (b"\r", b""):
                break
            desc += f.read(31)
            name = desc[:11].split(b"\x00")[0].decode("ascii", "replace")
            ftype = desc[11:12].decode("ascii")
            width = desc[16]
            decimals = desc[17]
            fields.append(DbfField(name, ftype, width, decimals))
        f.seek(header_size)
        records, deleted = [], []
        for _ in range(n_records):
            raw = f.read(record_size)
            if len(raw) < record_size:
                break
            deleted.append(raw[0:1] == b"*")
            rec, pos = {}, 1
            for fld in fields:
                cell = raw[pos:pos + fld.width].decode("ascii", "replace")
                pos += fld.width
                rec[fld.name] = _parse_cell(cell, fld)
            records.append(rec)
    return fields, records, deleted


def _parse_cell(cell: str, fld: DbfField):
    s = cell.strip()
    if fld.ftype in ("N", "F"):
        if not s or s in ("*" * len(s),):
            return None
        try:
            return int(s) if fld.decimals == 0 and fld.ftype == "N" else float(s)
        except ValueError:
            try:
                return float(s)
            except ValueError:
                return None
    if fld.ftype == "L":
        return s.upper() in ("T", "Y")
    return s


def _format_cell(value, fld: DbfField) -> bytes:
    if fld.ftype in ("N", "F"):
        if value is None:
            s = ""
        elif fld.decimals > 0 or fld.ftype == "F":
            s = f"{float(value):.{fld.decimals}f}"
        else:
            s = str(int(value))
        s = s.rjust(fld.width)[:fld.width]
    elif fld.ftype == "L":
        s = ("T" if value else "F").ljust(fld.width)
    else:
        s = ("" if value is None else str(value)).ljust(fld.width)[:fld.width]
    return s.encode("ascii", "replace")


def _write_dbf(path: str, fields: list[DbfField], records: list[dict],
               deleted: list[bool]) -> None:
    record_size = 1 + sum(f.width for f in fields)
    header_size = 32 + 32 * len(fields) + 1
    with open(path, "wb") as f:
        f.write(struct.pack("<BBBBIHH20x", 0x03, 126, 1, 1, len(records),
                            header_size, record_size))
        for fld in fields:
            name = fld.name.encode("ascii", "replace")[:11].ljust(11, b"\x00")
            f.write(name + fld.ftype.encode("ascii")
                    + b"\x00" * 4 + bytes([fld.width, fld.decimals])
                    + b"\x00" * 14)
        f.write(b"\r")
        for rec, dele in zip(records, deleted):
            f.write(b"*" if dele else b" ")
            for fld in fields:
                f.write(_format_cell(rec.get(fld.name), fld))
        f.write(b"\x1a")


# ---------------------------------------------------------------- SHP IO --

def _read_shp(path: str) -> tuple[int, list[ShapeObject], tuple]:
    with open(path, "rb") as f:
        header = f.read(100)
        if struct.unpack(">i", header[0:4])[0] != 9994:
            raise ValueError(f"{path}: not a shapefile")
        file_len = struct.unpack(">i", header[24:28])[0] * 2
        shape_type = struct.unpack("<i", header[32:36])[0]
        bbox = struct.unpack("<4d", header[36:68])
        shapes = []
        pos = 100
        while pos < file_len:
            rec_header = f.read(8)
            if len(rec_header) < 8:
                break
            content_len = struct.unpack(">i", rec_header[4:8])[0] * 2
            content = f.read(content_len)
            pos += 8 + content_len
            shapes.append(_parse_record(content))
    return _BASE_TYPE.get(shape_type, shape_type), shapes, bbox


def _parse_record(content: bytes) -> ShapeObject:
    stype = struct.unpack("<i", content[0:4])[0]
    base = _BASE_TYPE.get(stype, stype)
    if base == NULL:
        return ShapeObject(NULL, [])
    if base == POINT:
        x, y = struct.unpack("<2d", content[4:20])
        return ShapeObject(POINT, [np.array([[x, y]])])
    if base == MULTIPOINT:
        n = struct.unpack("<i", content[36:40])[0]
        pts = np.frombuffer(content[40:40 + 16 * n], "<f8").reshape(n, 2)
        return ShapeObject(MULTIPOINT, [pts.copy()])
    # polyline / polygon
    n_parts, n_points = struct.unpack("<2i", content[36:44])
    parts_idx = np.frombuffer(content[44:44 + 4 * n_parts], "<i4")
    off = 44 + 4 * n_parts
    pts = np.frombuffer(content[off:off + 16 * n_points], "<f8")
    pts = pts.reshape(n_points, 2)
    bounds = np.append(parts_idx, n_points)
    parts = [pts[bounds[i]:bounds[i + 1]].copy() for i in range(n_parts)]
    return ShapeObject(base, parts)


def _record_bytes(shape: ShapeObject) -> bytes:
    if shape.shape_type == NULL or not shape.parts:
        return struct.pack("<i", NULL)
    if shape.shape_type == POINT:
        x, y = shape.parts[0][0]
        return struct.pack("<i2d", POINT, x, y)
    allv = np.vstack(shape.parts)
    xmin, ymin = allv.min(axis=0)
    xmax, ymax = allv.max(axis=0)
    if shape.shape_type == MULTIPOINT:
        return (struct.pack("<i4di", MULTIPOINT, xmin, ymin, xmax, ymax,
                            len(allv))
                + allv.astype("<f8").tobytes())
    parts_idx = np.cumsum([0] + [len(p) for p in shape.parts[:-1]])
    return (struct.pack("<i4dii", shape.shape_type, xmin, ymin, xmax, ymax,
                        len(shape.parts), len(allv))
            + parts_idx.astype("<i4").tobytes()
            + allv.astype("<f8").tobytes())


# ---------------------------------------------------------- the handler --

class ShapeHandler:
    """Crit3DShapeHandler analogue: shapefile + DBF attribute table."""

    def __init__(self):
        self.filepath = ""
        self.shape_type = NULL
        self.shapes: list[ShapeObject] = []
        self.fields: list[DbfField] = []
        self.records: list[dict] = []
        self.deleted: list[bool] = []
        self.is_wgs84 = False
        self.is_north = True
        self.utm_zone = 32

    # -- open / save ------------------------------------------------------

    def open(self, filename: str) -> "ShapeHandler":
        base = os.path.splitext(filename)[0]
        self.filepath = base + ".shp"
        self.shape_type, self.shapes, _ = _read_shp(base + ".shp")
        if os.path.exists(base + ".dbf"):
            self.fields, self.records, self.deleted = _read_dbf(base + ".dbf")
        else:
            self.fields, self.deleted = [], [False] * len(self.shapes)
            self.records = [{} for _ in self.shapes]
        if os.path.exists(base + ".prj"):
            self._parse_prj(base + ".prj")
        return self

    def _parse_prj(self, path: str) -> None:
        """WGS84 / UTM-zone detection (shapeHandler.cpp isWGS84Proj /
        setUTMzone analogue)."""
        text = open(path).read().upper()
        self.is_wgs84 = "WGS_1984" in text or "WGS 84" in text
        import re
        m = re.search(r"UTM[_ ]ZONE[_ ](\d+)([NS]?)", text)
        if m:
            self.utm_zone = int(m.group(1))
            self.is_north = m.group(2) != "S"

    def new_shapefile(self, filename: str, shape_type: int) -> None:
        self.filepath = os.path.splitext(filename)[0] + ".shp"
        self.shape_type = shape_type
        self.shapes, self.fields, self.records, self.deleted = [], [], [], []

    def save(self, filename: str | None = None) -> None:
        base = os.path.splitext(filename or self.filepath)[0]
        records = [_record_bytes(s) for s in self.shapes]
        shx_entries, offset = [], 50                # in 16-bit words
        for r in records:
            shx_entries.append((offset, len(r) // 2))
            offset += 4 + len(r) // 2
        total_words = offset
        if self.shapes:
            allv = np.vstack([np.vstack(s.parts) for s in self.shapes
                              if s.parts])
            bbox = (allv[:, 0].min(), allv[:, 1].min(),
                    allv[:, 0].max(), allv[:, 1].max())
        else:
            bbox = (0.0, 0.0, 0.0, 0.0)
        header = (struct.pack(">i5i", 9994, 0, 0, 0, 0, 0)
                  + struct.pack(">i", total_words)
                  + struct.pack("<2i", 1000, self.shape_type)
                  + struct.pack("<4d", *bbox) + struct.pack("<4d", 0, 0, 0, 0))
        with open(base + ".shp", "wb") as f:
            f.write(header)
            for i, r in enumerate(records):
                f.write(struct.pack(">2i", i + 1, len(r) // 2))
                f.write(r)
        with open(base + ".shx", "wb") as f:
            shx_words = 50 + 4 * len(records)
            f.write(header[:24] + struct.pack(">i", shx_words) + header[28:])
            for off, length in shx_entries:
                f.write(struct.pack(">2i", off, length))
        _write_dbf(base + ".dbf", self.fields, self.records, self.deleted)

    # -- queries ----------------------------------------------------------

    @property
    def shape_count(self) -> int:
        return len(self.shapes)

    @property
    def field_count(self) -> int:
        return len(self.fields)

    def get_type_string(self) -> str:
        return _TYPE_NAME.get(self.shape_type, str(self.shape_type))

    def get_field_pos(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name.upper() == name.upper():
                return i
        return -1

    def exist_field(self, name: str) -> bool:
        return self.get_field_pos(name) >= 0

    def get_field_name(self, pos: int) -> str:
        return self.fields[pos].name

    def get_shape(self, index: int) -> ShapeObject:
        return self.shapes[index]

    def get_bounds(self) -> tuple[float, float, float, float]:
        allv = np.vstack([np.vstack(s.parts) for s in self.shapes if s.parts])
        return (allv[:, 0].min(), allv[:, 0].max(),
                allv[:, 1].min(), allv[:, 1].max())

    def get_numeric_value(self, shape_number: int, field) -> float:
        pos = field if isinstance(field, int) else self.get_field_pos(field)
        if pos < 0:
            return float("nan")
        v = self.records[shape_number].get(self.fields[pos].name)
        try:
            return float(v)
        except (TypeError, ValueError):
            return float("nan")

    def get_string_value(self, shape_number: int, field) -> str:
        pos = field if isinstance(field, int) else self.get_field_pos(field)
        if pos < 0:
            return ""
        v = self.records[shape_number].get(self.fields[pos].name)
        return "" if v is None else str(v)

    def get_shape_index_from_point(self, utm_x: float, utm_y: float) -> int:
        """Index of the (non-deleted) polygon containing the point; -1 if
        none (shapeHandler.cpp getShapeIndexfromPoint)."""
        for i, shape in enumerate(self.shapes):
            if self.deleted[i]:
                continue
            x0, y0, x1, y1 = shape.bounds
            if x0 <= utm_x <= x1 and y0 <= utm_y <= y1:
                if shape.contains(utm_x, utm_y):
                    return i
        return -1

    # -- edits ------------------------------------------------------------

    def add_field(self, name: str, ftype: str = "N", width: int = 18,
                  decimals: int = 6) -> int:
        if self.exist_field(name):
            return self.get_field_pos(name)
        self.fields.append(DbfField(name[:11], ftype, width, decimals))
        return len(self.fields) - 1

    def remove_field(self, field) -> None:
        pos = field if isinstance(field, int) else self.get_field_pos(field)
        name = self.fields[pos].name
        del self.fields[pos]
        for rec in self.records:
            rec.pop(name, None)

    def write_attribute(self, shape_number: int, field, value) -> None:
        pos = field if isinstance(field, int) else self.get_field_pos(field)
        self.records[shape_number][self.fields[pos].name] = value

    def add_shape(self, shape: ShapeObject, attributes: dict | None = None
                  ) -> int:
        self.shapes.append(shape)
        self.records.append(dict(attributes or {}))
        self.deleted.append(False)
        return len(self.shapes) - 1

    def delete_record(self, shape_number: int) -> None:
        self.deleted[shape_number] = True

    def exist_record_deleted(self) -> bool:
        return any(self.deleted)

    def pack(self) -> None:
        """Drop deleted records (packSHP/packDBF analogue)."""
        keep = [i for i, d in enumerate(self.deleted) if not d]
        self.shapes = [self.shapes[i] for i in keep]
        self.records = [self.records[i] for i in keep]
        self.deleted = [False] * len(keep)

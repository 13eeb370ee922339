"""XML-described generic meteo data import (agrolib/inOutDataXML analogue).

The port's own copy of ``criteria3d_tpu/io/import_xml.py``, line for line (host
numpy and the standard library).

An XML format descriptor declares how a delimited or FIXED-WIDTH text file
maps to (time, point code, variables); the importer then reads any such
file into per-variable series. Full token vocabulary of the reference
parser (inOutDataXML.cpp:49-400 parserXML):

    <filename>                        file-name driven point codes
      <path>..</path>
      <field><praganame/><prefix/><suffix/><nrchar/></field>
    <format>
      <type>fixed|xmlformatfixed|delimited|commaseparated|csv</type>
      <attribute>singlepoint|multipoint</attribute>
      <header|headerrows|numheaderrows>1</header>
      <missingvalue|missing_value|nodata>-9999</missingvalue>
      <delimiter>,</delimiter>
      <decimalseparator>.</decimalseparator>
    <pointcode>  <time>  <variablecode>
      <type|name/><format/><attribute/><field|position/>
      <first_char|firstchar/><nr_char|numchar|nrchar/>
      <align|alignment/><prefix|fixedtext/>
    <variable>
      <field>   ... same field tokens; TYPE = meteo variable name
      <flag><field>...</field><accepted>..</accepted></flag>
      <nreplication>1</nreplication>

Field value formats follow parseXMLFixedValue (inOutDataXML.cpp:720-770):
empty/%s string, %d int, and %[w][.d]f float with decimal rounding.
Time <type> DAILY parses a date, HOURLY a datetime, with Qt format strings.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import xml.etree.ElementTree as ET

import numpy as np

from criteria3d_tpu_torch.constants import NODATA

__all__ = ["ImportFormat", "FieldSpec", "VariableSpec", "parse_import_xml",
           "import_data", "point_code_from_filename"]

# Qt date format -> strptime translation (QDateTime::fromString semantics)
_QT_TO_STRPTIME = [
    ("yyyy", "%Y"), ("yy", "%y"), ("MM", "%m"), ("dd", "%d"),
    ("HH", "%H"), ("hh", "%H"), ("mm", "%M"), ("ss", "%S"),
]


def qt_format_to_strptime(fmt: str) -> str:
    out = ""
    i = 0
    while i < len(fmt):
        for qt, py in _QT_TO_STRPTIME:
            if fmt.startswith(qt, i):
                out += py
                i += len(qt)
                break
        else:
            out += fmt[i]
            i += 1
    return out


@dataclasses.dataclass
class FieldSpec:
    """One FieldXML (fieldXML.h): position / fixed span / format tokens."""

    position: int = -1        # delimited column index
    first_char: int = -1      # fixed-width start (1-based, like the reference)
    nr_char: int = 0
    name: str = ""            # TYPE/NAME
    format: str = ""          # "", %s, %d, %[w].[d]f
    attribute: str = ""
    alignment: str = ""
    prefix: str = ""

    def raw(self, line: str, parts: list, delimited: bool,
            n_replication: int = 0) -> str:
        if delimited and self.position >= 0:
            if 0 <= self.position < len(parts):
                return parts[self.position].strip()
            return ""
        if self.nr_char <= 0:
            return line.rstrip("\n")
        start = max(self.first_char - 1, 0) + n_replication * self.nr_char
        return line[start:start + self.nr_char]

    def value(self, line: str, parts: list, delimited: bool,
              decimal_separator: str = ".", n_replication: int = 0):
        """Typed value or the string "ERROR" on a parse failure
        (parseXMLFixedValue, inOutDataXML.cpp:720-770)."""
        sub = self.raw(line, parts, delimited, n_replication)
        if not sub:
            return "ERROR"
        fmt = self.format
        if fmt in ("", "%s"):
            return sub
        sub = sub.strip()
        if decimal_separator != ".":
            sub = sub.replace(decimal_separator, ".")
        if fmt == "%d":
            try:
                return int(sub)
            except ValueError:
                return "ERROR"
        if fmt.endswith("f"):
            try:
                v = float(sub)
            except ValueError:
                return "ERROR"
            if "." in fmt:
                nd = fmt[fmt.index(".") + 1:fmt.index("f")]
                try:
                    v = float(f"{v:.{int(nd)}f}")
                except ValueError:
                    pass
            return v
        return sub


@dataclasses.dataclass
class VariableSpec:
    """One VariableXML: the value field plus optional accept-flag field."""

    var_field: FieldSpec = dataclasses.field(default_factory=FieldSpec)
    flag_field: FieldSpec = dataclasses.field(default_factory=FieldSpec)
    flag_accepted: str = ""
    n_replication: int = 1

    @property
    def name(self) -> str:
        return self.var_field.name


@dataclasses.dataclass
class ImportFormat:
    delimited: bool = True
    single_point: bool = True
    delimiter: str = ","
    decimal_separator: str = "."
    header_rows: int = 0
    missing_value: float = float(NODATA)
    time: FieldSpec = dataclasses.field(default_factory=FieldSpec)
    time_format: str = "%Y-%m-%d %H:%M"
    time_type: str = "HOURLY"             # DAILY | HOURLY
    point_code: FieldSpec = dataclasses.field(default_factory=FieldSpec)
    variable_code: FieldSpec = dataclasses.field(default_factory=FieldSpec)
    variables: list = dataclasses.field(default_factory=list)
    # <filename> section (file-name defined point codes / export naming)
    filename_path: str = ""
    filename_praga_name: str = ""
    filename_prefixes: list = dataclasses.field(default_factory=list)
    filename_suffixes: list = dataclasses.field(default_factory=list)
    nr_filename_chars: int = 0


def _fill_field(node, spec: FieldSpec, fmt: ImportFormat | None = None,
                time_field: bool = False) -> None:
    for child in node:
        t = child.tag.upper()
        text = (child.text or "").strip()
        if t in ("FIELD", "POSITION"):
            # inside a <variable><field> the FIELD tag may hold sub-tags
            if len(child):
                continue
            spec.position = int(text)
        elif t in ("FIRST_CHAR", "FIRSTCHAR"):
            spec.first_char = int(text)
        elif t in ("NR_CHAR", "NUMCHAR", "NRCHAR"):
            spec.nr_char = int(text)
        elif t in ("TYPE", "NAME"):
            if time_field and fmt is not None:
                fmt.time_type = text.upper()
            else:
                spec.name = text
        elif t == "FORMAT":
            if time_field and fmt is not None:
                fmt.time_format = qt_format_to_strptime(text)
            else:
                spec.format = text
        elif t == "ATTRIBUTE":
            spec.attribute = text
        elif t in ("ALIGN", "ALIGNMENT"):
            spec.alignment = text
        elif t in ("PREFIX", "FIXEDTEXT"):
            spec.prefix = text


def parse_import_xml(path: str) -> ImportFormat:
    root = ET.parse(path).getroot()
    fmt = ImportFormat()
    saw_attribute = False

    for node in root:
        tag = node.tag.upper()
        if tag == "FILENAME":
            for child in node:
                t = child.tag.upper()
                if t == "PATH":
                    fmt.filename_path = (child.text or "").strip()
                elif t == "FIELD":
                    for sub in child:
                        st = sub.tag.upper()
                        text = (sub.text or "").strip()
                        if st in ("PRAGANAME", "PRAGAFIELD"):
                            fmt.filename_praga_name = text
                        elif st in ("PREFIX", "FIXEDPREFIX"):
                            fmt.filename_prefixes.append(text)
                        elif st in ("SUFFIX", "FIXEDSUFFIX"):
                            fmt.filename_suffixes.append(text)
                        elif st in ("NRCHAR", "NR_CHAR"):
                            fmt.nr_filename_chars = int(text)
        elif tag == "FORMAT":
            for child in node:
                t = child.tag.upper()
                text = (child.text or "").strip()
                if t == "TYPE":
                    fmt.delimited = text.upper() not in ("FIXED",
                                                         "XMLFORMATFIXED")
                elif t == "DELIMITER":
                    fmt.delimiter = child.text or ","
                elif t == "DECIMALSEPARATOR":
                    fmt.decimal_separator = text or "."
                elif t in ("HEADER", "HEADERROWS", "NUMHEADERROWS"):
                    fmt.header_rows = int(text)
                elif t in ("MISSINGVALUE", "MISSING_VALUE", "NODATA"):
                    fmt.missing_value = float(text)
                elif t == "ATTRIBUTE":
                    fmt.single_point = text.upper() == "SINGLEPOINT"
                    saw_attribute = True
        elif tag == "TIME":
            _fill_field(node, fmt.time, fmt, time_field=True)
        elif tag == "POINTCODE":
            _fill_field(node, fmt.point_code)
        elif tag == "VARIABLECODE":
            _fill_field(node, fmt.variable_code)
        elif tag == "VARIABLE":
            var = VariableSpec()
            for child in node:
                t = child.tag.upper()
                if t == "FIELD":
                    if len(child):
                        _fill_field(child, var.var_field)
                    else:
                        var.var_field.position = int((child.text or "0").strip())
                elif t == "FLAG":
                    for sub in child:
                        st = sub.tag.upper()
                        if st == "FIELD":
                            _fill_field(sub, var.flag_field)
                        elif st == "ACCEPTED":
                            var.flag_accepted = (sub.text or "").strip()
                elif t in ("NREPLICATION", "N_REPLICATION"):
                    var.n_replication = int((child.text or "1").strip())
                else:
                    # flat schema: tokens directly under <variable>
                    _fill_field([child], var.var_field)
            fmt.variables.append(var)

    if not saw_attribute:
        # no explicit <attribute>: infer — a point-code field located in
        # the data lines means a multi-point file
        fmt.single_point = not (fmt.point_code.position >= 0
                                or fmt.point_code.first_char >= 1)
    return fmt


def point_code_from_filename(data_path: str, fmt: ImportFormat) -> str:
    """Point code from the data file's base name
    (checkPointCodeFromFileName + parseXMLPointCode's FILENAMEDEFINED
    branches, inOutDataXML.cpp:430-466, 689-718): either the first
    ``pointcode.nr_char`` characters, or the base name with the
    <filename> fixed prefixes/suffixes stripped."""
    base = os.path.splitext(os.path.basename(data_path))[0]
    if fmt.filename_praga_name or fmt.filename_prefixes or \
            fmt.filename_suffixes:
        code = base
        for p in fmt.filename_prefixes:
            code = code.replace(p, "")
        for s in fmt.filename_suffixes:
            code = code.replace(s, "")
        return code
    if fmt.point_code.nr_char > 0:
        return base[:fmt.point_code.nr_char]
    return base


def import_data(data_path: str, fmt: ImportFormat) -> dict:
    """Read a data file with the parsed format (importXMLDataFixed /
    importXMLDataDelimited, inOutDataXML.cpp:468-688).

    Returns ``{"time": [datetime/date...], "point": [codes...],
    "<variable name>": np.array, "nr_errors": int}`` with NODATA where a
    value failed to parse or its accept-flag did not match.
    """
    times, points = [], []
    series = {v.name or f"var{i}": [] for i, v in enumerate(fmt.variables)}
    nr_errors = 0

    file_code = point_code_from_filename(data_path, fmt) \
        if fmt.single_point else ""

    daily = fmt.time_type.upper() == "DAILY"

    with open(data_path) as f:
        for i, line in enumerate(f):
            if i < fmt.header_rows or not line.strip():
                continue
            line = line.rstrip("\n")
            parts = line.split(fmt.delimiter) if fmt.delimited else []

            t_str = fmt.time.raw(line, parts, fmt.delimited).strip()
            try:
                t = datetime.datetime.strptime(t_str, fmt.time_format)
            except ValueError:
                continue
            times.append(t.date() if daily else t)

            if fmt.single_point:
                points.append(file_code)
            else:
                code = fmt.point_code.value(line, parts, fmt.delimited)
                points.append("" if code == "ERROR" else str(code))

            for iv, spec in enumerate(fmt.variables):
                name = spec.name or f"var{iv}"
                # accept-flag gate (only string/int flag formats, like the
                # reference's importXMLData* flag branches)
                if spec.flag_accepted and spec.flag_field.format in (
                        "", "%s", "%d"):
                    flag = spec.flag_field.value(line, parts, fmt.delimited)
                    accepted = spec.flag_accepted
                    if spec.flag_field.format == "%d":
                        try:
                            accepted = int(accepted)
                        except ValueError:
                            pass
                    elif isinstance(flag, str):
                        flag = flag.strip()
                    if flag != accepted:
                        series[name].append(NODATA)
                        continue
                v = spec.var_field.value(line, parts, fmt.delimited,
                                         fmt.decimal_separator)
                if isinstance(v, str) and v != "ERROR":
                    # empty/%s format on a variable field: numeric import
                    s = v.strip()
                    if fmt.decimal_separator != ".":
                        s = s.replace(fmt.decimal_separator, ".")
                    try:
                        v = float(s)
                    except ValueError:
                        v = "ERROR"
                if v == "ERROR":
                    nr_errors += 1
                    v = NODATA
                elif float(v) == fmt.missing_value:
                    v = NODATA
                series[name].append(float(v))

    out = {"time": times, "point": points, "nr_errors": nr_errors}
    out.update({k: np.asarray(v) for k, v in series.items()})
    return out

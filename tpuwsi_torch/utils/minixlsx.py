"""Flat tables without pandas: the .xlsx reader and writer (standard library
zipfile + XML) and a .csv reader (``tpuwsi/utils/minixlsx.py``).

The reference's metadata is xlsx (``slides_data_<id>.xlsx``,
``Grids_<mag>/Grid_data.xlsx``, ``run_data.xlsx``): one worksheet, a header
row, str/float/int/bool cells. The JAX package reads them into a pandas
``DataFrame``; this module hands back a **column table**, a dict of column
name → list of values in row order, typed as pandas types the columns of
``pd.DataFrame(rows, columns=header)`` (``typed_column``):

- integers only → ``int``; integers with a blank → ``float`` with NaN;
- numbers → ``float``, a blank → NaN;
- strings only → ``str``, a blank → NaN;
- booleans only → ``bool``; with a blank, or any other mix → the values as
  they are, a blank as ``None``.

``read_csv`` follows ``pd.read_csv``'s defaults instead: each column is
integers, floats or booleans if every non-blank cell parses as one,
else strings.
"""

from __future__ import annotations

import csv
import math
import os
import re
import zipfile
from typing import Dict, List
from xml.etree import ElementTree as ET
from xml.sax.saxutils import escape

import numpy as np

Table = Dict[str, list]

_NS = {"m": "http://schemas.openxmlformats.org/spreadsheetml/2006/main"}


def is_null(v) -> bool:
    """pandas' ``isnull`` for one value: None or a float NaN."""
    return v is None or (isinstance(v, (float, np.floating)) and math.isnan(v))


def _kind(v) -> str:
    if isinstance(v, (bool, np.bool_)):
        return "bool"
    if isinstance(v, (int, np.integer)):
        return "int"
    if isinstance(v, (float, np.floating)):
        return "float"
    if isinstance(v, str):
        return "str"
    return "object"


def typed_column(values) -> list:
    """One column as ``pd.DataFrame`` types it (module docstring), as the
    Python values ``list(series)`` gives."""
    values = list(values)
    kinds = {_kind(v) for v in values if not is_null(v)}
    has_null = any(is_null(v) for v in values)
    if kinds == {"bool"} and not has_null:
        return [bool(v) for v in values]
    if kinds == {"int"} and not has_null:
        return [int(v) for v in values]
    if kinds and kinds <= {"int", "float"}:
        return [math.nan if is_null(v) else float(v) for v in values]
    if kinds == {"str"}:
        return [math.nan if is_null(v) else v for v in values]
    return values


def column_kind(values) -> str:
    """'bool', 'int', 'float', 'str' or 'object': the dtype of a column that
    ``typed_column`` made."""
    kinds = {_kind(v) for v in values}
    if len(kinds) == 1 and kinds != {"object"}:
        return kinds.pop()
    if kinds == {"str", "float"} and all(is_null(v) for v in values if _kind(v) == "float"):
        return "str"
    return "object"


def scalar(values, i: int):
    """``series.iloc[i]``: a numpy scalar in a bool, int or float column, the
    value itself in any other."""
    kind = column_kind(values)
    v = values[i]
    if kind == "bool":
        return np.bool_(v)
    if kind == "int":
        return np.int64(v)
    if kind == "float":
        return np.float64(v)
    return v


def n_rows(table: Table) -> int:
    return len(next(iter(table.values()))) if table else 0


def _col_to_idx(ref: str) -> int:
    m = re.match(r"([A-Z]+)", ref)
    idx = 0
    for ch in m.group(1):
        idx = idx * 26 + (ord(ch) - 64)
    return idx - 1


def _from_rows(header: list, rows: List[list]) -> Table:
    if len(set(header)) != len(header):
        raise ValueError(f"duplicate column names in {header}")
    return {name: typed_column(r[c] for r in rows) for c, name in enumerate(header)}


def read_xlsx(path: str) -> Table:
    with zipfile.ZipFile(path) as z:
        shared: List[str] = []
        if "xl/sharedStrings.xml" in z.namelist():
            root = ET.fromstring(z.read("xl/sharedStrings.xml"))
            for si in root.findall("m:si", _NS):
                shared.append("".join(t.text or "" for t in si.iter("{%s}t" % _NS["m"])))
        sheet_name = next(
            n for n in z.namelist()
            if n.startswith("xl/worksheets/sheet") and n.endswith(".xml")
        )
        root = ET.fromstring(z.read(sheet_name))
        rows: Dict[int, Dict[int, object]] = {}
        max_col = -1
        for row in root.iter("{%s}row" % _NS["m"]):
            r = int(row.get("r")) - 1
            for c in row.findall("m:c", _NS):
                col = _col_to_idx(c.get("r"))
                max_col = max(max_col, col)
                t = c.get("t", "n")
                v = c.find("m:v", _NS)
                is_node = c.find("m:is", _NS)
                if t == "s" and v is not None:
                    val = shared[int(v.text)]
                elif t == "inlineStr" and is_node is not None:
                    val = "".join(tt.text or "" for tt in is_node.iter("{%s}t" % _NS["m"]))
                elif t == "b" and v is not None:
                    val = bool(int(v.text))
                elif v is not None and v.text is not None:
                    f = float(v.text)
                    val = int(f) if f.is_integer() else f
                else:
                    val = None
                rows.setdefault(r, {})[col] = val
    if not rows:
        return {}
    header_row = min(rows)
    header = [rows[header_row].get(c) for c in range(max_col + 1)]
    data = [[rows[r].get(c) for c in range(max_col + 1)] for r in sorted(rows) if r != header_row]
    return _from_rows(header, data)


def _cell_xml(ref: str, value) -> str:
    if is_null(value):
        return ""
    if isinstance(value, (bool, np.bool_)):
        return f'<c r="{ref}" t="b"><v>{int(value)}</v></c>'
    if isinstance(value, (int, float, np.integer, np.floating)):
        return f'<c r="{ref}"><v>{value}</v></c>'
    return f'<c r="{ref}" t="inlineStr"><is><t>{escape(str(value))}</t></is></c>'


def _idx_to_col(idx: int) -> str:
    col = ""
    idx += 1
    while idx:
        idx, rem = divmod(idx - 1, 26)
        col = chr(65 + rem) + col
    return col


_CONTENT_TYPES = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">'
    '<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>'
    '<Default Extension="xml" ContentType="application/xml"/>'
    '<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>'
    '<Override PartName="/xl/worksheets/sheet1.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.worksheet+xml"/>'
    "</Types>"
)
_RELS = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
    '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>'
    "</Relationships>"
)
_WORKBOOK = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" '
    'xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">'
    '<sheets><sheet name="Sheet1" sheetId="1" r:id="rId1"/></sheets></workbook>'
)
_WORKBOOK_RELS = (
    '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
    '<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">'
    '<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/worksheet" Target="worksheets/sheet1.xml"/>'
    "</Relationships>"
)


def write_xlsx(path: str, table: Table):
    """One worksheet: the column names, then a row per table row (blank
    cells for None and NaN)."""
    names = list(table)
    parts = ['<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
             '<worksheet xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main">'
             "<sheetData>"]
    header = "".join(_cell_xml(f"{_idx_to_col(c)}1", name) for c, name in enumerate(names))
    parts.append(f'<row r="1">{header}</row>')
    for r in range(n_rows(table)):
        cells = "".join(_cell_xml(f"{_idx_to_col(c)}{r + 2}", table[name][r])
                        for c, name in enumerate(names))
        parts.append(f'<row r="{r + 2}">{cells}</row>')
    parts.append("</sheetData></worksheet>")

    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", _CONTENT_TYPES)
        z.writestr("_rels/.rels", _RELS)
        z.writestr("xl/workbook.xml", _WORKBOOK)
        z.writestr("xl/_rels/workbook.xml.rels", _WORKBOOK_RELS)
        z.writestr("xl/worksheets/sheet1.xml", "".join(parts))


# pd.read_csv's default NA strings and its boolean words
_NA = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
       "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null"}
_TRUE, _FALSE = {"True", "TRUE", "true"}, {"False", "FALSE", "false"}
_INT = re.compile(r"^[+-]?\d+$")
_FLOAT = re.compile(r"^[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?|inf|Inf|INF)$")


def _csv_column(cells: List[str]) -> list:
    present = [c for c in cells if c not in _NA]
    if present and all(_INT.match(c) for c in present):
        return typed_column(None if c in _NA else int(c) for c in cells)
    if present and all(_FLOAT.match(c) for c in present):
        return [math.nan if c in _NA else float(c) for c in cells]
    if present and all(c in _TRUE or c in _FALSE for c in present):
        return [math.nan if c in _NA else c in _TRUE for c in cells]
    return [math.nan if c in _NA else c for c in cells]


def read_csv(path: str) -> Table:
    """A comma-separated file with a header row, typed as ``pd.read_csv``
    types it (module docstring)."""
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    if not rows:
        return {}
    header, body = rows[0], rows[1:]
    if len(set(header)) != len(header):
        raise ValueError(f"{path}: duplicate column names in {header}")
    return {name: _csv_column([r[c] if c < len(r) else "" for r in body])
            for c, name in enumerate(header)}


def read_table(path_no_ext: str) -> Table:
    """``<path>.xlsx``, else ``<path>.csv``; a ``.parquet`` table raises
    (this package reads no parquet), and so does a missing one."""
    for ext, reader in ((".xlsx", read_xlsx), (".csv", read_csv)):
        if os.path.isfile(path_no_ext + ext):
            return reader(path_no_ext + ext)
    if os.path.isfile(path_no_ext + ".parquet"):
        raise NotImplementedError(
            f"{path_no_ext}.parquet: parquet tables need pyarrow through pandas, which "
            "this package does not use; save the table as .xlsx or .csv")
    raise FileNotFoundError(path_no_ext + ".xlsx")

"""Minimal stdlib .xlsx writer/reader (zipfile + ElementTree).

The reference's artifact FORMATS are part of its surface: it writes
``all_generations.xlsx`` (one sheet per generation, nsga_penalty.py:785-788),
exports final Pareto fronts to .xlsx (nsga_penalty.py:819-821), and the PSI
2-stage pipeline reads ``Final.xlsx`` (psi_init_sa_nsga.py:365-379,
psi_mobo_2.py:365-369). This image ships pandas but no Excel engine
(openpyxl/xlsxwriter absent), so pandas' read_excel/to_excel raise
ImportError; this module provides the subset of OOXML SpreadsheetML those
artifacts actually need, with zero third-party dependencies:

* ``write_xlsx(path, sheets)`` — workbook of typed cells (str/bool/number),
  strings inline (no sharedStrings table needed on the write side). A sheet
  is a header list plus rows of values, so the write path needs no pandas.
* ``read_rows(path)`` -> (column names, rows) of a .xlsx or .csv table
  without pandas, with ``pd.read_excel``/``pd.read_csv``'s column names and
  cell values. The .xlsx side understands inline strings plus the
  sharedStrings table, booleans and numbers — i.e. sharedStrings-format
  files of the kind Excel writers like openpyxl emit. (No Excel engine
  exists in this image, so openpyxl interop specifically is asserted only
  against hand-built sharedStrings fixtures in tests/test_xlsx.py, not
  against openpyxl's own output.) It is the package's one table reader:
  the PSI seed file, the fronts of cli/compare.py, cli/train_final.py and
  cli/psi_merge.py.

Not supported (and not used by the reference's artifacts): formulas, styles,
dates, merged cells, multi-row headers.
"""

from __future__ import annotations

import math
import re
import zipfile
from typing import Dict, Iterable, List, Sequence, Tuple, Union
from xml.etree import ElementTree as ET
from xml.sax.saxutils import escape

import numpy as np

_MAIN_NS = "http://schemas.openxmlformats.org/spreadsheetml/2006/main"
_REL_NS = "http://schemas.openxmlformats.org/officeDocument/2006/relationships"
_PKG_REL_NS = "http://schemas.openxmlformats.org/package/2006/relationships"


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _col_name(idx: int) -> str:
    """0-based column index -> spreadsheet column letters (0 -> A)."""
    name = ""
    idx += 1
    while idx:
        idx, rem = divmod(idx - 1, 26)
        name = chr(ord("A") + rem) + name
    return name


def _cell_xml(ref: str, value) -> str:
    # numpy scalars behave like their Python counterparts for isinstance
    # checks below via item()
    if isinstance(value, np.generic):
        value = value.item()
    if value is None or (isinstance(value, float) and value != value):
        return f'<c r="{ref}"/>'  # blank cell for None/NaN
    if isinstance(value, bool):
        return f'<c r="{ref}" t="b"><v>{int(value)}</v></c>'
    if isinstance(value, float) and math.isinf(value):
        # xsd:double spells infinity INF/-INF; Python's repr ('inf') is not
        # valid OOXML and external readers reject the cell
        return f'<c r="{ref}"><v>{"INF" if value > 0 else "-INF"}</v></c>'
    if isinstance(value, (int, float)):
        return f'<c r="{ref}"><v>{value!r}</v></c>'
    text = escape(str(value))
    return f'<c r="{ref}" t="inlineStr"><is><t xml:space="preserve">{text}</t></is></c>'


def _sheet_xml(rows: Iterable[Sequence]) -> str:
    parts = [
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>',
        f'<worksheet xmlns="{_MAIN_NS}"><sheetData>',
    ]
    for r_i, row in enumerate(rows, start=1):
        cells = "".join(
            _cell_xml(f"{_col_name(c_i)}{r_i}", v) for c_i, v in enumerate(row)
        )
        parts.append(f'<row r="{r_i}">{cells}</row>')
    parts.append("</sheetData></worksheet>")
    return "".join(parts)


Table = Tuple[Sequence[str], Sequence[Sequence]]  # (header, rows)
SheetsArg = Union[Dict[str, Table], Sequence[Tuple[str, Table]]]


def write_xlsx(path: str, sheets: SheetsArg) -> str:
    """Write (header, rows) tables as a .xlsx workbook; header row then
    values, exactly like ``DataFrame.to_excel(..., index=False)``."""
    named: List[Tuple[str, Table]] = (
        list(sheets.items()) if isinstance(sheets, dict) else list(sheets)
    )
    if not named:
        raise ValueError("write_xlsx needs at least one sheet")

    sheet_entries = []
    rel_entries = []
    ct_entries = []
    for i, (name, _df) in enumerate(named, start=1):
        sheet_entries.append(
            f'<sheet name="{escape(str(name), {chr(34): "&quot;"})}" '
            f'sheetId="{i}" r:id="rId{i}"/>'
        )
        rel_entries.append(
            f'<Relationship Id="rId{i}" Type="{_REL_NS}/worksheet" '
            f'Target="worksheets/sheet{i}.xml"/>'
        )
        ct_entries.append(
            f'<Override PartName="/xl/worksheets/sheet{i}.xml" ContentType='
            '"application/vnd.openxmlformats-officedocument.spreadsheetml.'
            'worksheet+xml"/>'
        )

    content_types = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        '<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">'
        '<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>'
        '<Default Extension="xml" ContentType="application/xml"/>'
        '<Override PartName="/xl/workbook.xml" ContentType="application/vnd.'
        'openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>'
        + "".join(ct_entries)
        + "</Types>"
    )
    root_rels = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        f'<Relationships xmlns="{_PKG_REL_NS}">'
        f'<Relationship Id="rId1" Type="{_REL_NS}/officeDocument" Target="xl/workbook.xml"/>'
        "</Relationships>"
    )
    workbook = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        f'<workbook xmlns="{_MAIN_NS}" xmlns:r="{_REL_NS}">'
        f'<sheets>{"".join(sheet_entries)}</sheets></workbook>'
    )
    workbook_rels = (
        '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
        f'<Relationships xmlns="{_PKG_REL_NS}">'
        + "".join(rel_entries)
        + "</Relationships>"
    )

    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("[Content_Types].xml", content_types)
        zf.writestr("_rels/.rels", root_rels)
        zf.writestr("xl/workbook.xml", workbook)
        zf.writestr("xl/_rels/workbook.xml.rels", workbook_rels)
        for i, (_name, (header, rows)) in enumerate(named, start=1):
            zf.writestr(
                f"xl/worksheets/sheet{i}.xml",
                _sheet_xml([list(header)] + [list(r) for r in rows]),
            )
    return path


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

_CELL_REF_RE = re.compile(r"([A-Z]+)(\d+)")


def _col_index(letters: str) -> int:
    idx = 0
    for ch in letters:
        idx = idx * 26 + (ord(ch) - ord("A") + 1)
    return idx - 1


def _local(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def _cell_value(cell: ET.Element, shared: List[str]):
    ctype = cell.get("t", "n")
    if ctype == "inlineStr":
        return "".join(
            t.text or "" for t in cell.iter() if _local(t.tag) == "t"
        )
    v = None
    for child in cell:
        if _local(child.tag) == "v":
            v = child.text
            break
    if v is None:
        return None
    if ctype == "s":
        return shared[int(v)]
    if ctype == "b":
        return bool(int(v))
    if ctype == "str":
        return v
    # numeric: keep ints exact (genome columns), floats otherwise. Integer-
    # formatted cells parse through int() directly so magnitudes beyond
    # 2**53 survive bit-exactly (float(v) would silently round them).
    try:
        return int(v)
    except ValueError:
        pass
    f = float(v)  # also accepts the xsd:double spellings INF/-INF/NaN
    return int(f) if f.is_integer() and abs(f) < 2 ** 53 else f


def sheet_names(path: str) -> List[str]:
    with zipfile.ZipFile(path) as zf:
        wb = ET.fromstring(zf.read("xl/workbook.xml"))
    sheets = [s for s in wb.iter() if _local(s.tag) == "sheet"]
    return [s.get("name", f"Sheet{i + 1}") for i, s in enumerate(sheets)]


def _xlsx_table(path: str, sheet: Union[int, str] = 0):
    """One worksheet as (header cells, body rows) of typed cells, None where
    a cell is empty; ([], []) for an empty sheet."""
    with zipfile.ZipFile(path) as zf:
        wb = ET.fromstring(zf.read("xl/workbook.xml"))
        sheets = [s for s in wb.iter() if _local(s.tag) == "sheet"]
        if not sheets:
            raise ValueError(f"{path}: workbook has no sheets")
        if isinstance(sheet, str):
            matches = [s for s in sheets if s.get("name") == sheet]
            if not matches:
                raise ValueError(f"{path}: no sheet named {sheet!r}")
            target = matches[0]
        else:
            target = sheets[sheet]
        rid = target.get(f"{{{_REL_NS}}}id")
        rels = ET.fromstring(zf.read("xl/_rels/workbook.xml.rels"))
        rel_map = {
            r.get("Id"): r.get("Target")
            for r in rels.iter()
            if _local(r.tag) == "Relationship"
        }
        sheet_path = "xl/" + rel_map[rid].lstrip("/").removeprefix("xl/")

        shared: List[str] = []
        if "xl/sharedStrings.xml" in zf.namelist():
            ss = ET.fromstring(zf.read("xl/sharedStrings.xml"))
            for si in ss:
                shared.append(
                    "".join(
                        t.text or ""
                        for t in si.iter()
                        if _local(t.tag) == "t"
                    )
                )

        ws = ET.fromstring(zf.read(sheet_path))

    rows: Dict[int, Dict[int, object]] = {}
    max_col = -1
    for row in ws.iter():
        if _local(row.tag) != "row":
            continue
        r_num = int(row.get("r", len(rows) + 1)) - 1
        cells: Dict[int, object] = {}
        next_col = 0
        for cell in row:
            if _local(cell.tag) != "c":
                continue
            ref = cell.get("r")
            if ref:
                m = _CELL_REF_RE.match(ref)
                col = _col_index(m.group(1)) if m else next_col
            else:
                col = next_col
            next_col = col + 1
            cells[col] = _cell_value(cell, shared)
            max_col = max(max_col, col)
        rows[r_num] = cells

    if not rows:
        return [], []
    n_cols = max_col + 1
    ordered = [rows.get(i, {}) for i in range(max(rows) + 1)]
    table = [[r.get(c) for c in range(n_cols)] for r in ordered]
    return table[0], table[1:]


def _column_names(header: Sequence) -> List[str]:
    """``pd.read_excel``/``pd.read_csv`` column names: an empty header cell
    is ``Unnamed: <index>``."""
    return [h if h is not None else f"Unnamed: {i}"
            for i, h in enumerate(header)]


# pd.read_csv's default missing-value spellings
_NA_VALUES = {
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
}
_TRUE = {"True", "TRUE", "true"}
_FALSE = {"False", "FALSE", "false"}
_INT_RE = re.compile(r"\s*[+-]?\d+\s*\Z")
_FLOAT_RE = re.compile(r"\s*([+-]?)(\d*)(?:\.(\d*))?(?:[eE]([+-]?\d+))?\s*\Z")
_INF = {"inf": 1, "+inf": 1, "-inf": -1, "infinity": 1, "+infinity": 1,
        "-infinity": -1}
_POW10 = [float(f"1e{k}") for k in range(309)]


def _csv_float(text: str):
    """``pd.read_csv``'s float conversion (its default "high" precision
    parser, pandas' ``precise_xstrtod``), or None for text that is no
    number. It is not correctly rounded: the first 17 significant digits
    accumulate in a double, which one multiplication or division by a
    power of ten then scales, so a value can differ from ``float(text)`` in
    its last bit. The same double operations give the same bits."""
    inf = _INF.get(text.strip().lower())
    if inf:
        return inf * float("inf")
    m = _FLOAT_RE.match(text)
    if not m or not (m.group(2) or m.group(3)):
        return None
    sign, int_part, frac_part, exp = m.groups()
    number, digits, exponent = 0.0, 0, 0
    for ch in int_part:
        if digits < 17:
            number = number * 10.0 + (ord(ch) - 48)
            digits += 1
        else:
            exponent += 1
    for ch in (frac_part or "")[:max(17 - digits, 0)]:
        number = number * 10.0 + (ord(ch) - 48)
        exponent -= 1
    if sign == "-":
        number = -number
    if exp:
        exponent += (-1 if exp[0] == "-" else 1) * int(exp.lstrip("+-")[:17])
    if exponent > 308:
        return math.copysign(float("inf"), number)
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -616:
        return 0.0 * number
    if exponent < -308:
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _csv_column(cells: Sequence[str]) -> List:
    """One CSV column typed as ``pd.read_csv`` infers it: int, else float,
    else bool, else str. A missing cell is NaN, which turns an int column
    float."""
    nan = float("nan")
    present = [c for c in cells if c not in _NA_VALUES]
    if all(_INT_RE.match(c) for c in present):
        conv = int if len(present) == len(cells) else _csv_float
        return [conv(c) if c not in _NA_VALUES else nan for c in cells]
    floats = [_csv_float(c) if c not in _NA_VALUES else nan for c in cells]
    if all(v is not None for v in floats):
        return floats
    if all(c in _TRUE or c in _FALSE for c in present):
        return [c in _TRUE if c not in _NA_VALUES else nan for c in cells]
    return [c if c not in _NA_VALUES else nan for c in cells]


def _read_csv_rows(path: str) -> Tuple[List[str], List[List]]:
    import csv

    with open(path, newline="") as f:
        lines = [r for r in csv.reader(f) if r]  # blank lines are skipped
    if not lines:
        raise ValueError("No columns to parse from file")
    header, body = lines[0], lines[1:]
    for i, r in enumerate(body):
        if len(r) > len(header):
            raise ValueError(f"row {i + 1}: expected {len(header)} fields, "
                             f"saw {len(r)}")
        r.extend([""] * (len(header) - len(r)))
    names: List[str] = []
    for name in _column_names([h if h else None for h in header]):
        # pd.read_csv renames a repeated column name X to X.1, X.2, ...
        base, k = name, 0
        while name in names:
            k += 1
            name = f"{base}.{k}"
        names.append(name)
    columns = [_csv_column([r[j] for r in body]) for j in range(len(header))]
    return names, [list(cells) for cells in zip(*columns)] if body else []


def read_rows(path: str) -> Tuple[List[str], List[List]]:
    """Read a .xlsx or .csv front or seed table without pandas: (column
    names, rows of cell values), the names and values ``pd.read_excel`` or
    ``pd.read_csv`` would give. A missing cell reads as NaN.
    FileNotFoundError propagates unchanged (callers distinguish 'missing'
    from 'corrupt'), and EVERY other read or parse failure is normalized to
    UnreadableTableError, so callers need exactly two except clauses."""
    nan = float("nan")
    try:
        if path.endswith((".xlsx", ".xls")):
            header, body = _xlsx_table(path)
            return _column_names(header), [
                [nan if v is None else v for v in r] for r in body]
        return _read_csv_rows(path)
    except FileNotFoundError:
        raise
    except Exception as exc:  # noqa: BLE001 — deliberate normalization
        raise UnreadableTableError(f"{type(exc).__name__}: {exc}") from exc


class UnreadableTableError(Exception):
    """A front/seed table exists but cannot be parsed — zero-byte file, torn
    sheet XML, corrupted deflate stream, wrong format, or an engine-specific
    parse error (e.g. lxml's XMLSyntaxError under openpyxl, which is a
    SyntaxError subclass and escapes naive (ValueError, ...) envelopes)."""

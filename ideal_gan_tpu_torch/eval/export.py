"""Result exporters: ROI-crop npy stacks and xlsx workbooks (port of
`ideal_gan_tpu/eval/export.py`).

The reference persists ROI crops as three stacked `np.save`s
(frms, crops_1, crops_2 — utils.py:29-35) and exports ROI statistics to
xlsx worksheets (RHL/LHL sheets in ROI-analysis.py:419-567; per-slice
sheets in ROI-realPhantom.py). openpyxl and xlsxwriter are not
dependencies, so `XlsxWriter` here is a minimal, dependency-free
implementation of the OOXML spreadsheet format (a zip of XML parts with
inline strings) that standard readers (pandas/Excel/LibreOffice) open.
"""

from __future__ import annotations

import zipfile
from pathlib import Path
from typing import Sequence

import numpy as np


# ---------------------------------------------------------------------------
# ROI crop files
# ---------------------------------------------------------------------------

def save_crops(path: str, frms, crops_1, crops_2) -> None:
    with open(path, "wb") as f:
        np.save(f, np.asarray(frms))
        np.save(f, np.asarray(crops_1))
        np.save(f, np.asarray(crops_2))


def load_crops(path: str):
    with open(path, "rb") as f:
        frms = np.load(f)
        crops_1 = np.load(f)
        crops_2 = np.load(f)
    return frms, crops_1, crops_2


# ---------------------------------------------------------------------------
# Minimal xlsx writer
# ---------------------------------------------------------------------------

def _xml_escape(s: str) -> str:
    return (s.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")
            .replace('"', "&quot;"))


def _col_name(idx: int) -> str:
    name = ""
    idx += 1
    while idx:
        idx, rem = divmod(idx - 1, 26)
        name = chr(65 + rem) + name
    return name


class Worksheet:
    def __init__(self, name: str):
        self.name = name
        self._cells: dict[tuple[int, int], object] = {}

    def write(self, row: int, col: int, value) -> None:
        self._cells[(row, col)] = value

    def write_row(self, row: int, values: Sequence, start_col: int = 0):
        for j, v in enumerate(values):
            self.write(row, start_col + j, v)

    def to_xml(self) -> str:
        rows: dict[int, dict[int, object]] = {}
        for (r, c), v in self._cells.items():
            rows.setdefault(r, {})[c] = v
        body = []
        for r in sorted(rows):
            cells = []
            for c in sorted(rows[r]):
                v = rows[r][c]
                ref = f"{_col_name(c)}{r + 1}"
                if isinstance(v, str):
                    cells.append(
                        f'<c r="{ref}" t="inlineStr"><is><t>'
                        f"{_xml_escape(v)}</t></is></c>")
                else:
                    fv = float(v)
                    if not np.isfinite(fv):
                        cells.append(
                            f'<c r="{ref}" t="inlineStr"><is><t>'
                            f"{fv}</t></is></c>")
                    else:
                        cells.append(f'<c r="{ref}"><v>{fv!r}</v></c>')
            body.append(f'<row r="{r + 1}">' + "".join(cells) + "</row>")
        return (
            '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            '<worksheet xmlns="http://schemas.openxmlformats.org/'
            'spreadsheetml/2006/main"><sheetData>'
            + "".join(body) + "</sheetData></worksheet>")


class XlsxWriter:
    """Workbook with `add_worksheet(name)` → Worksheet (xlsxwriter-style
    API, matching the reference's usage) and `close()` to write the file."""

    def __init__(self, path: str):
        self.path = Path(path)
        self._sheets: list[Worksheet] = []

    def add_worksheet(self, name: str) -> Worksheet:
        ws = Worksheet(name)
        self._sheets.append(ws)
        return ws

    def close(self) -> None:
        if not self._sheets:
            self.add_worksheet("Sheet1")
        n = len(self._sheets)
        content_types = (
            '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            '<Types xmlns="http://schemas.openxmlformats.org/package/2006/'
            'content-types">'
            '<Default Extension="rels" ContentType="application/'
            'vnd.openxmlformats-package.relationships+xml"/>'
            '<Default Extension="xml" ContentType="application/xml"/>'
            '<Override PartName="/xl/workbook.xml" ContentType="application/'
            'vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>'
            + "".join(
                f'<Override PartName="/xl/worksheets/sheet{i + 1}.xml" '
                'ContentType="application/vnd.openxmlformats-officedocument.'
                'spreadsheetml.worksheet+xml"/>' for i in range(n))
            + "</Types>")
        rels = (
            '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            '<Relationships xmlns="http://schemas.openxmlformats.org/'
            'package/2006/relationships">'
            '<Relationship Id="rId1" Type="http://schemas.openxmlformats.'
            'org/officeDocument/2006/relationships/officeDocument" '
            'Target="xl/workbook.xml"/></Relationships>')
        sheets_xml = "".join(
            f'<sheet name="{_xml_escape(ws.name)}" sheetId="{i + 1}" '
            f'r:id="rId{i + 1}"/>' for i, ws in enumerate(self._sheets))
        workbook = (
            '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            '<workbook xmlns="http://schemas.openxmlformats.org/'
            'spreadsheetml/2006/main" xmlns:r="http://schemas.'
            'openxmlformats.org/officeDocument/2006/relationships">'
            f"<sheets>{sheets_xml}</sheets></workbook>")
        wb_rels = (
            '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            '<Relationships xmlns="http://schemas.openxmlformats.org/'
            'package/2006/relationships">'
            + "".join(
                f'<Relationship Id="rId{i + 1}" Type="http://schemas.'
                'openxmlformats.org/officeDocument/2006/relationships/'
                f'worksheet" Target="worksheets/sheet{i + 1}.xml"/>'
                for i in range(n))
            + "</Relationships>")
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with zipfile.ZipFile(self.path, "w", zipfile.ZIP_DEFLATED) as z:
            z.writestr("[Content_Types].xml", content_types)
            z.writestr("_rels/.rels", rels)
            z.writestr("xl/workbook.xml", workbook)
            z.writestr("xl/_rels/workbook.xml.rels", wb_rels)
            for i, ws in enumerate(self._sheets):
                z.writestr(f"xl/worksheets/sheet{i + 1}.xml", ws.to_xml())


def read_xlsx(path: str) -> dict[str, list[list]]:
    """Minimal xlsx reader: {sheet_name: rows} with numbers parsed.

    Supports inline strings (our writer) and shared strings (files written
    by Excel/openpyxl) — enough to read back ROI tables and the steatosis
    label sheets the reference's LDM trainer consumes
    (train-ldm.py:91-102)."""
    import xml.etree.ElementTree as ET

    ns = {"m": "http://schemas.openxmlformats.org/spreadsheetml/2006/main",
          "r": ("http://schemas.openxmlformats.org/officeDocument/2006/"
                "relationships")}
    with zipfile.ZipFile(path) as z:
        shared = []
        if "xl/sharedStrings.xml" in z.namelist():
            root = ET.fromstring(z.read("xl/sharedStrings.xml"))
            for si in root.findall("m:si", ns):
                shared.append("".join(t.text or ""
                                      for t in si.iter(
                                          f"{{{ns['m']}}}t")))
        wb = ET.fromstring(z.read("xl/workbook.xml"))
        rels = {}
        if "xl/_rels/workbook.xml.rels" in z.namelist():
            rel_root = ET.fromstring(z.read("xl/_rels/workbook.xml.rels"))
            for rel in rel_root:
                rels[rel.get("Id")] = rel.get("Target")
        sheets = {}
        for i, sheet in enumerate(wb.find("m:sheets", ns)):
            name = sheet.get("name")
            rid = sheet.get(f"{{{ns['r']}}}id")
            target = rels.get(rid, f"worksheets/sheet{i + 1}.xml")
            if not target.startswith("xl/"):
                target = "xl/" + target
            ws = ET.fromstring(z.read(target))
            rows = []
            for row in ws.iter(f"{{{ns['m']}}}row"):
                cells = []
                for c in row.findall("m:c", ns):
                    t = c.get("t")
                    if t == "inlineStr":
                        is_el = c.find("m:is/m:t", ns)
                        cells.append(is_el.text if is_el is not None else "")
                    else:
                        v = c.find("m:v", ns)
                        if v is None:
                            cells.append(None)
                        elif t == "s":
                            cells.append(shared[int(v.text)])
                        else:
                            try:
                                fv = float(v.text)
                                cells.append(int(fv) if fv == int(fv)
                                             else fv)
                            except ValueError:
                                cells.append(v.text)
                rows.append(cells)
            sheets[name] = rows
    return sheets

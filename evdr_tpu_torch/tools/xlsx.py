"""Minimal dependency-free .xlsx writer (inline-string SpreadsheetML).

The torch port's copy of ``evdr_tpu/tools/xlsx.py`` (stdlib only).

The environment has no openpyxl; this writes the small subset needed by the
results reporter: multiple sheets of text/number cells. Readable by Excel,
LibreOffice, pandas, and openpyxl.
"""

from __future__ import annotations

import zipfile
from pathlib import Path
from typing import Dict, List, Sequence, Union

Cell = Union[str, int, float, None]

_CONTENT_TYPES = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Types xmlns="http://schemas.openxmlformats.org/package/2006/content-types">
<Default Extension="rels" ContentType="application/vnd.openxmlformats-package.relationships+xml"/>
<Default Extension="xml" ContentType="application/xml"/>
<Override PartName="/xl/workbook.xml" ContentType="application/vnd.openxmlformats-officedocument.spreadsheetml.sheet.main+xml"/>
{sheet_overrides}
</Types>"""

_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
<Relationship Id="rId1" Type="http://schemas.openxmlformats.org/officeDocument/2006/relationships/officeDocument" Target="xl/workbook.xml"/>
</Relationships>"""

_WORKBOOK = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<workbook xmlns="http://schemas.openxmlformats.org/spreadsheetml/2006/main" xmlns:r="http://schemas.openxmlformats.org/officeDocument/2006/relationships">
<sheets>{sheets}</sheets>
</workbook>"""

_WORKBOOK_RELS = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<Relationships xmlns="http://schemas.openxmlformats.org/package/2006/relationships">
{rels}
</Relationships>"""


def _esc(s: str) -> str:
    return (s.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")
            .replace('"', "&quot;"))


def _col_name(i: int) -> str:
    name = ""
    i += 1
    while i:
        i, rem = divmod(i - 1, 26)
        name = chr(65 + rem) + name
    return name


def _sheet_xml(rows: Sequence[Sequence[Cell]]) -> str:
    parts = ['<?xml version="1.0" encoding="UTF-8" standalone="yes"?>',
             '<worksheet xmlns="http://schemas.openxmlformats.org/'
             'spreadsheetml/2006/main"><sheetData>']
    for r, row in enumerate(rows, start=1):
        parts.append(f'<row r="{r}">')
        for c, val in enumerate(row):
            if val is None:
                continue
            ref = f"{_col_name(c)}{r}"
            if isinstance(val, (int, float)) and not isinstance(val, bool):
                parts.append(f'<c r="{ref}"><v>{val}</v></c>')
            else:
                parts.append(
                    f'<c r="{ref}" t="inlineStr"><is><t>{_esc(str(val))}</t>'
                    f'</is></c>')
        parts.append("</row>")
    parts.append("</sheetData></worksheet>")
    return "".join(parts)


def write_xlsx(path, sheets: Dict[str, List[List[Cell]]]) -> None:
    """sheets: {sheet_name: rows of cells}. Order preserved."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    names = list(sheets)
    sheet_tags = "".join(
        f'<sheet name="{_esc(n)}" sheetId="{i + 1}" r:id="rId{i + 1}"/>'
        for i, n in enumerate(names))
    rel_tags = "\n".join(
        f'<Relationship Id="rId{i + 1}" Type="http://schemas.openxmlformats.org/'
        f'officeDocument/2006/relationships/worksheet" '
        f'Target="worksheets/sheet{i + 1}.xml"/>'
        for i in range(len(names)))
    overrides = "\n".join(
        f'<Override PartName="/xl/worksheets/sheet{i + 1}.xml" ContentType='
        f'"application/vnd.openxmlformats-officedocument.spreadsheetml.'
        f'worksheet+xml"/>'
        for i in range(len(names)))

    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("[Content_Types].xml",
                    _CONTENT_TYPES.format(sheet_overrides=overrides))
        zf.writestr("_rels/.rels", _RELS)
        zf.writestr("xl/workbook.xml", _WORKBOOK.format(sheets=sheet_tags))
        zf.writestr("xl/_rels/workbook.xml.rels",
                    _WORKBOOK_RELS.format(rels=rel_tags))
        for i, name in enumerate(names):
            zf.writestr(f"xl/worksheets/sheet{i + 1}.xml",
                        _sheet_xml(sheets[name]))

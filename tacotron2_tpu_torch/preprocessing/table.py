"""The manifests as the data preparation reads and writes them: pipe-separated
CSVs with a header row and no quoting, held as a column list and one dict a
row.

A field read stays the string it was, so an int column is written back as
it was read (``92``). A value the code computes is a float, written as its
shortest repr, as pandas' ``to_csv`` writes a float; NaN (and None) is an
empty field, and an empty field reads back as NaN (``column``).
"""

from __future__ import annotations

import csv
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

Rows = List[Dict[str, object]]


def read_table(path: str) -> Tuple[List[str], Rows]:
    with open(path, newline="") as f:
        reader = csv.reader(f, delimiter="|", quoting=csv.QUOTE_NONE)
        header = next(reader)
        return header, [dict(zip(header, r)) for r in reader if r]


def _field(v) -> str:
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return ""
    return repr(float(v)) if isinstance(v, (float, np.floating)) else str(v)


def write_table(path: str, header: Sequence[str], rows: Rows) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter="|", quoting=csv.QUOTE_NONE, lineterminator="\n")
        w.writerow(header)
        w.writerows([_field(r.get(c)) for c in header] for r in rows)


def column(rows: Rows, name: str) -> np.ndarray:
    """A numeric column as f64, empty fields as NaN."""
    return np.array([float(v) if v not in ("", None) else math.nan for v in
                     (r.get(name) for r in rows)], np.float64)


def add_columns(header: List[str], names: Sequence[str]) -> None:
    """Columns not in the header go at its end, in order (a DataFrame's
    ``df[names] = ...``)."""
    header += [n for n in names if n not in header]


def concat(*tables: Tuple[List[str], Rows]) -> Tuple[List[str], Rows]:
    """Rows of every table in turn; the columns of the first, then each new
    one in order of appearance (``pd.concat``); a missing field is empty."""
    header: List[str] = []
    for h, _ in tables:
        add_columns(header, h)
    return header, [r for _, rows in tables for r in rows]

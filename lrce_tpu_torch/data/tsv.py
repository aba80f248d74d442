"""A tab-separated label file as a list of typed row dicts.

The JAX package reads the TGIF annotation files with ``pandas.read_csv(path,
delimiter="\\t")`` and takes rows with ``.iloc[i][column]``. The port does
not need pandas: ``read_tsv`` gives the same values with the standard
``csv`` module:

  - the first row names the columns; a UTF-8 byte-order mark is dropped;
  - default quoting (``"`` quotes, ``""`` inside quotes is one ``"``);
  - blank lines are skipped; a short row is filled with missing values;
  - a cell that is exactly one of pandas' default missing-value strings
    (``""``, ``"NA"``, ``"null"``, ``"nan"``, ...) is missing;
  - each column is typed as pandas infers it: ``np.int64`` when every cell
    is an integer and none is missing, ``np.float64`` when every cell is a
    number or missing (missing is NaN), else ``str`` with a missing cell as
    ``np.nan`` (the same object pandas gives).

What pandas does that this does not (ROADMAP, Queue 3 "Known
differences"): a row longer than the header, a repeated column name and a
column of true / false (which pandas would type as bool) raise here; an
integer outside int64 stays ``str`` here (pandas gives uint64 or Python
ints). No TGIF annotation file has any of them.
"""

from __future__ import annotations

import csv
import re
from typing import List

import numpy as np

# pandas' default na_values (pandas._libs.parsers.STR_NA_VALUES), compared
# with the cell exactly, before any stripping
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"})

# numbers as pandas' C parser reads them: surrounding spaces allowed, no
# digit separators (Python's int() / float() would take "1_000")
_INT = re.compile(r"\s*[+-]?\d+\s*")
_FLOAT = re.compile(
    r"\s*[+-]?(?:(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?|inf|infinity)\s*",
    re.IGNORECASE)
_INT64 = (-2**63, 2**63 - 1)


def _type_column(cells: List[str]) -> list:
    present = [c for c in cells if c not in NA_STRINGS]
    complete = bool(present) and len(present) == len(cells)
    if complete and all(_INT.fullmatch(c) for c in present):
        ints = [int(c) for c in present]
        if all(_INT64[0] <= v <= _INT64[1] for v in ints):
            return [np.int64(v) for v in ints]
        return list(cells)
    if present and all(c.lower() in ("true", "false") for c in present):
        raise ValueError("a column of true / false: bool columns are not read")
    if all(_FLOAT.fullmatch(c) for c in present):
        return [np.float64("nan") if c in NA_STRINGS else np.float64(float(c))
                for c in cells]
    return [np.nan if c in NA_STRINGS else c for c in cells]


def read_tsv(path: str) -> List[dict]:
    """Rows of a tab-separated file with a header, each a dict of column
    name -> typed value, in file order."""
    with open(path, "r", encoding="utf-8-sig", newline="") as f:
        rows = [r for r in csv.reader(f, delimiter="\t") if r]
    if not rows:
        raise ValueError(f"{path}: no header")
    header, body = rows[0], rows[1:]
    if len(set(header)) < len(header):
        raise ValueError(f"{path}: a column name repeats in {header}")
    for i, r in enumerate(body):
        if len(r) > len(header):
            raise ValueError(f"{path}: data row {i} has {len(r)} cells, the "
                             f"header {len(header)}")
    columns = [_type_column([r[j] if j < len(r) else "" for r in body])
               for j in range(len(header))]
    return [dict(zip(header, values)) for values in zip(*columns)]

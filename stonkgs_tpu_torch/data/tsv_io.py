"""Tab-separated tables with a header, written and read as pandas does.

:func:`write_table` (columns) and :func:`write_records` (dicts with the
same keys) write a table byte for byte as ``pandas.DataFrame(...).to_csv(
path, sep="\\t", index=False)`` writes it, without pandas: pandas writes through the
``csv`` module with minimal quoting, after inferring each column's type:

* integers only: ``str`` of each;
* numbers only (not bools), with a float or a missing value among them: a
  float64 column, written as numpy's ``astype(str)`` writes it (an
  integer ``1`` as ``1.0``), a missing value as an empty field;
* anything else: an object column, each cell as the ``csv`` writer
  writes it (``repr`` of a float, ``str`` of anything else), None and NaN
  as empty fields.

No records write an empty header line, as an empty DataFrame does.
:func:`read_columns` reads such a file back through the same ``csv``
module, fields kept as the file spells them.
"""

from __future__ import annotations

import csv
import math
from numbers import Integral, Real
from typing import Dict, List, Sequence

import numpy as np


def _writer(f):
    return csv.writer(f, delimiter="\t", lineterminator="\n", quoting=csv.QUOTE_MINIMAL,
                      quotechar='"', doublequote=True)


def _is_missing(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def _column(values: list) -> list:
    """One column's cells, typed as pandas infers the column."""
    present = [v for v in values if not _is_missing(v)]
    numeric = bool(present) and all(isinstance(v, Real) and not isinstance(v, (bool, np.bool_))
                                    for v in present)
    if numeric and len(present) == len(values) and all(isinstance(v, Integral)
                                                       for v in values):
        return [str(v) for v in values]
    if numeric:
        cells = np.asarray([np.nan if _is_missing(v) else float(v) for v in values],
                           np.float64).astype(str).tolist()
        return ["" if _is_missing(v) else c for v, c in zip(values, cells)]
    return [None if _is_missing(v) else v for v in values]


def write_table(path: str, table: Dict[str, list], *, mode: str = "w",
                header: bool = True) -> None:
    """Write ``table`` (column name -> cells, columns of equal length) as
    ``DataFrame(table).to_csv(path, sep="\\t", index=False, mode=mode,
    header=header)`` would."""
    cols = [_column(list(v)) for v in table.values()]
    with open(path, mode, encoding="utf-8", newline="") as f:
        writer = _writer(f)
        if header:
            if table:
                writer.writerow(list(table))
            else:
                f.write("\n")
        writer.writerows(zip(*cols))


def write_records(path: str, records: List[dict]) -> None:
    """Write ``records`` (dicts with the first record's keys) as
    ``DataFrame(records).to_csv(path, sep="\\t", index=False)`` would."""
    columns = list(records[0]) if records else []
    write_table(path, {c: [r[c] for r in records] for c in columns})


def read_columns(path: str, names: Sequence[str], sep: str = "\t") -> Dict[str, List[str]]:
    """The named columns of a table with a header, as strings (quoted
    fields undone, blank lines skipped)."""
    with open(path, encoding="utf-8", newline="") as f:
        reader = csv.reader(f, delimiter=sep, quotechar='"', doublequote=True)
        header = next(reader, [])
        where = {n: header.index(n) for n in names}
        rows = [r for r in reader if r]
    return {n: [r[i] for r in rows] for n, i in where.items()}


def count_records(path: str) -> int:
    """Rows of a TSV with a header, a quoted field with line breaks
    counting once (``len(pandas.read_csv(path, sep="\\t"))``)."""
    with open(path, encoding="utf-8", newline="") as f:
        return max(sum(1 for r in csv.reader(f, delimiter="\t") if r) - 1, 0)

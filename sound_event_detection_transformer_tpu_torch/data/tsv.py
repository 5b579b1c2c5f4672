"""Metadata tables as rows: tab-separated files read and written with ``csv``.

The JAX package reads and writes its metadata with pandas, which the card's
machine lacks.  Here a table is a list of dicts, one per line, keyed by the
header's column names in their order.  Reading follows what pandas'
``read_csv(sep="\\t")`` gives the code that uses it: an empty cell is None
(pandas' NaN), so is a cell missing at the end of a short line, ``onset``
and ``offset`` are float64, every other cell stays a string, and blank lines
are skipped.  Writing follows ``to_csv(sep="\\t",
index=False)``: floats by ``repr``, None as an empty cell, ``\\n`` line ends.
"""
from __future__ import annotations

import csv
import os
import os.path as osp
from typing import Dict, List, Sequence

FLOAT_COLUMNS = ("onset", "offset")


def _cell(column: str, value: str):
    if value == "":
        return None
    return float(value) if column in FLOAT_COLUMNS else value


def read_tsv(path: str) -> List[Dict]:
    """The rows of a TSV with a header line, as dicts."""
    with open(path, newline="") as f:
        reader = csv.reader(f, delimiter="\t")
        columns = next(reader)
        # a short line's missing cells are empty, as pandas reads them
        return [{c: _cell(c, v) for c, v in zip(columns, line + [""] * (len(columns) - len(line)))}
                for line in reader if line]


def write_tsv(path: str, columns: Sequence[str], rows) -> None:
    """Write ``rows`` (sequences in ``columns``' order) under a header line,
    creating the directory."""
    if osp.dirname(path):
        os.makedirs(osp.dirname(path), exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, delimiter="\t", lineterminator="\n")
        writer.writerow(columns)
        writer.writerows(["" if v is None else v for v in row] for row in rows)


def unique(values) -> List:
    """``values`` without repeats, in first-seen order (pandas'
    ``drop_duplicates``)."""
    return list(dict.fromkeys(values))

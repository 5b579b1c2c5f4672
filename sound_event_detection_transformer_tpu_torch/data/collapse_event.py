"""URBAN-SED metadata preparation, on rows.

Counterpart of the JAX package's ``data/collapse_event.py``: the per-file
annotation files ``annotations/<split>/<clip>.txt`` (onset, offset and label
per line, no header) become ``metadata/<split>.tsv``, with overlapping or
touching events of one class in one file merged into one span.  This is the
first step a user with the real URBAN-SED runs:

    python -m sound_event_detection_transformer_tpu_torch.data.collapse_event <URBAN-SED dir>
"""
from __future__ import annotations

import csv
import glob
import os.path as osp
import sys
from itertools import groupby
from typing import List, Optional, Sequence, Tuple

from .tsv import write_tsv

Row = Tuple[str, float, float, str]  # (filename, onset, offset, event_label)
COLUMNS = ("filename", "onset", "offset", "event_label")
SPLITS = ("train", "validate", "test")


def collapse(rows: Sequence[Row]) -> List[Row]:
    """Merge the overlapping or touching events of each (file, class); rows
    without a label are dropped.  The result is ordered by file and onset,
    and by class where both tie."""
    out: List[Row] = []
    key = lambda r: (r[0], r[3])
    labelled = sorted((r for r in rows if r[3] is not None), key=key)
    for (fname, label), grp in groupby(labelled, key=key):
        cur_on = cur_off = None
        for _, on, off, _ in sorted(grp, key=lambda r: r[1]):
            if cur_on is None:
                cur_on, cur_off = on, off
            elif on <= cur_off:  # overlap or touch: extend
                cur_off = max(cur_off, off)
            else:
                out.append((fname, cur_on, cur_off, label))
                cur_on, cur_off = on, off
        out.append((fname, cur_on, cur_off, label))
    return sorted(out, key=lambda r: (r[0], r[1]))


def read_annotations(path: str) -> List[Tuple[float, float, str]]:
    """One annotation file's (onset, offset, label) lines."""
    with open(path, newline="") as f:
        return [(float(on), float(off), label or None)
                for on, off, label in (line for line in csv.reader(f, delimiter="\t") if line)]


def build_urbansed_tsvs(urbansed_dir: str, out_dir: Optional[str] = None) -> None:
    """``annotations/<split>/*.txt`` -> ``<out_dir>/<split>.tsv`` (``out_dir``
    defaults to ``<urbansed_dir>/metadata``)."""
    out_dir = out_dir or osp.join(urbansed_dir, "metadata")
    for split in SPLITS:
        rows = []
        for txt in sorted(glob.glob(osp.join(urbansed_dir, "annotations", split, "*.txt"))):
            fname = osp.splitext(osp.basename(txt))[0] + ".wav"
            rows.extend((fname, on, off, label) for on, off, label in read_annotations(txt))
        write_tsv(osp.join(out_dir, f"{split}.tsv"), COLUMNS, collapse(rows))


if __name__ == "__main__":
    build_urbansed_tsvs(sys.argv[1] if len(sys.argv) > 1 else "./data/URBAN-SED_v2.0.0")

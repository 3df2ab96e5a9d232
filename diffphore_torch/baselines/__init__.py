"""Baseline-comparison drivers (pharmacophore aligners, docking, target
fishing): the port's copy of ``diffphore_tpu.baselines``.  They orchestrate
external binaries (AncPhore/pharao/pharmer, the vina family, IFPTarget);
a binary absent from the machine gives a clean skip, while the pure-logic
pieces (random phore generation, conformer generation, SDF splitting,
performance tables) run on the host.  No pandas: tables are read with
``data/dataset.py::records_from_csv`` (:func:`read_frame`) and written with
``cli/inference.py::_write_table`` (:func:`write_frame`), rows ordered as
pandas' ``sort_values`` orders them (:func:`sort_order`)."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def sort_order(values: Sequence[float], ascending: bool = True) -> List[int]:
    """The row order of pandas' ``sort_values(col, ascending=...)`` on one
    float column (``nargsort``): numpy's default (unstable) quicksort of the
    non-NaN values, reversed before and after for a descending sort, so ties
    land where pandas puts them, and the NaN rows last in their order."""
    items = np.asarray(values, dtype=float)
    idx = np.arange(len(items))
    mask = np.isnan(items)
    non_nans, non_nan_idx = items[~mask], idx[~mask]
    if not ascending:
        non_nans, non_nan_idx = non_nans[::-1], non_nan_idx[::-1]
    indexer = non_nan_idx[non_nans.argsort(kind="quicksort")]
    if not ascending:
        indexer = indexer[::-1]
    return [int(i) for i in np.concatenate([indexer, idx[mask]])]


def write_frame(path: str, rows: List[dict]) -> None:
    """``pd.DataFrame(rows).to_csv(path, index=False)`` for rows whose values
    keep one type per column: the columns in order of first appearance, a
    cell a row lacks empty."""
    from ..cli.inference import _write_table

    columns = list(dict.fromkeys(k for r in rows for k in r))
    _write_table(path, [[r.get(c, float("nan")) for c in columns] for r in rows],
                 columns=columns, sep=",")


def read_frame(path: str) -> List[Dict]:
    """``pd.read_csv(path).to_dict("records")``."""
    from ..data.dataset import records_from_csv

    return records_from_csv(path, pandas_records=True)

"""Tagged console logging, a JSONL metrics sink and a running-mean meter."""

from __future__ import annotations

import collections
import json
import os
from typing import Dict, List, Optional


def log_info(msg: str) -> None:
    print(f"[I] {msg}", flush=True)


class MetricsWriter:
    """Append-only JSONL metrics sink (a no-op without a path)."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self._f = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a")

    def write(self, record: dict) -> None:
        if self._f:
            self._f.write(json.dumps(record) + "\n")
            self._f.flush()

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None

    def __enter__(self) -> "MetricsWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class AverageMeter:
    """Per-key running means, with optional per-sigma-interval keys
    (``int<i>_<key>``)."""

    def __init__(self, types: List[str]):
        self.types = list(types)
        self.acc: Dict[str, float] = collections.defaultdict(float)
        self.count: Dict[str, int] = collections.defaultdict(int)

    def add(self, vals: Dict[str, float], interval_idx: Optional[int] = None) -> None:
        for k, v in vals.items():
            key = k if interval_idx is None else f"int{interval_idx}_{k}"
            self.acc[key] += float(v)
            self.count[key] += 1

    def summary(self) -> Dict[str, float]:
        return {k: self.acc[k] / max(self.count[k], 1) for k in self.acc}

"""Tagged console logging, phase timers, a JSONL metrics sink and a
running-mean meter."""

from __future__ import annotations

import collections
import contextlib
import json
import os
import sys
import threading
import time
from typing import Dict, List, Optional


def log_info(msg: str) -> None:
    print(f"[I] {msg}", flush=True)


def log_warn(msg: str) -> None:
    print(f"[W] {msg}", flush=True)


def log_error(msg: str) -> None:
    print(f"[E] {msg}", file=sys.stderr, flush=True)


class PhaseTimers:
    """Accumulating named wall-clock timers, safe to use from several
    threads (a lock guards each read-add-store)."""

    def __init__(self) -> None:
        self.totals: Dict[str, float] = collections.defaultdict(float)
        self.counts: Dict[str, int] = collections.defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        """Add a phase timed elsewhere (in a worker process)."""
        with self._lock:
            self.totals[name] += seconds
            self.counts[name] += 1

    def report(self) -> str:
        return " ".join(f"{k}={v:.2f}s" for k, v in sorted(self.totals.items()))


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

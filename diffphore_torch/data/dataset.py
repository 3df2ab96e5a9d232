"""Datasets over directories of featurized complexes.

The JAX package featurizes raw files into one ``.npz`` per complex under
``<cache_path>/<name>_<settings digest>/``.  :class:`CachedDataset` reads
such directories; featurizing raw files is not part of the port yet.
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from .graphs import ComplexBatch, load_cached


class CachedDataset:
    """The ``.npz`` complexes of one or more cache directories, in sorted
    order, as B = 1 ``ComplexBatch``es on the CPU."""

    def __init__(self, directories: Sequence[str], limit: int = 0, ram_cache: bool = True):
        self.files: List[str] = []
        for d in directories:
            if not os.path.isdir(d):
                raise FileNotFoundError(f"cache directory `{d}` not found")
            self.files.extend(sorted(glob.glob(os.path.join(d, "*.npz"))))
        if limit:
            self.files = self.files[:limit]
        self._ram: Optional[Dict[int, ComplexBatch]] = {} if ram_cache else None

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> ComplexBatch:
        if self._ram is None:
            return load_cached(self.files[idx])
        hit = self._ram.get(idx)
        if hit is None:
            hit = self._ram[idx] = load_cached(self.files[idx])
        return hit


class Subset:
    """Index view of a dataset (the warm-up epochs train on fewer samples)."""

    def __init__(self, dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)
        self.files = [dataset.files[i] for i in self.indices]

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, idx: int) -> ComplexBatch:
        return self.dataset[self.indices[idx]]


def warmup_subset(dataset, number: int, proportion: float, seed: int = 0):
    """Random warm-up subset: ``number`` samples when > 0, else
    ``proportion`` of the dataset."""
    n = min(number, len(dataset)) if number > 0 else max(1, int(proportion * len(dataset)))
    if n >= len(dataset):
        return dataset
    rng = np.random.default_rng(seed)
    return Subset(dataset, rng.permutation(len(dataset))[:n])


def cache_directories(cache_path: str, name: str) -> List[str]:
    """The ``<cache_path>/<name>_*`` directories, sorted."""
    return sorted(d for d in glob.glob(os.path.join(cache_path, f"{name}_*")) if os.path.isdir(d))

"""On-disk cache of the numpy score-norm tables (SO(3) and torus).

Tables are built once with numpy and kept as ``.npz`` under ``build/tables``
in the checkout, which git ignores.
"""

from __future__ import annotations

import os
from typing import Callable, Dict

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CACHE_DIR = os.path.join(_ROOT, "build", "tables")


def cached_tables(name: str, build: Callable[[], Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    path = os.path.join(CACHE_DIR, name + ".npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    tables = build()
    os.makedirs(CACHE_DIR, exist_ok=True)
    # write-then-rename: concurrent test workers may build the same table
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, **tables)
    os.replace(tmp, path)
    return tables

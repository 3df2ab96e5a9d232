"""Host processes that featurize beside the device work."""

from __future__ import annotations

import contextlib
import os
import sys
import types
from typing import Iterator

#: thread counts of the numeric libraries in a featurization process: their
#: arrays are small, and idle threads of several processes spin against one
#: another on the host's cores
WORKER_THREADS = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


@contextlib.contextmanager
def worker_environment() -> Iterator[None]:
    """Within the block, processes started by this one (spawn: the caller
    may hold a CUDA context, which a worker never touches) start with one
    thread per numeric library; the environment is restored after it."""
    saved = {k: os.environ.get(k) for k in WORKER_THREADS}
    os.environ.update(WORKER_THREADS)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def bare_main() -> Iterator[None]:
    """Within the block, processes spawned by this one do not import its
    main module.  Spawn re-imports it in every child, and the CLI's imports
    torch and the whole package: seconds of a featurization worker's start
    that it does not need.  For children that run a function of an
    importable module (pickled by name)."""
    main = sys.modules["__main__"]
    sys.modules["__main__"] = types.ModuleType("__main__")
    try:
        yield
    finally:
        sys.modules["__main__"] = main

"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

Each source under ``diffphore_torch/csrc/`` compiles, at first use, into a
shared library with a plain C interface under ``build/kernels/`` in the
checkout.  The library's name carries a hash of its source, so an edited
source is rebuilt and a built one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(ARCH_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def compile_command(name: str, out: str) -> List[str]:
    # --split-compile=0: nvcc optimizes a source's kernels on all the cores,
    # which halves the build of the heavily templated sources
    # (chip_smoke.py prints the build's seconds)
    return [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "--split-compile=0", "-Xptxas", "-v", "-o", out, os.path.join(CSRC, name + ".cu")]


def build(names: List[str]) -> Dict[str, Tuple[str, str]]:
    """Compile the named sources, one nvcc process each, all at once.
    Returns {name: (library path, compiler log)}; raises if any fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs: Dict[str, Tuple[subprocess.Popen, str, str]] = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            procs[name] = (None, out, out)
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(compile_command(name, tmp), stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp, out)
    result, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        if proc is None:
            result[name] = (out, "(already built)")
            continue
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
        result[name] = (out, log)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return result


def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not os.path.exists(path):
                build([name])
            lib = ctypes.CDLL(path)
            _loaded[name] = lib
        return lib

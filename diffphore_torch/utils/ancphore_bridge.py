"""Subprocess bridge to the native AncPhore-contract scorer CLI.

The port's copy of ``diffphore_tpu.utils.ancphore_bridge``: the same
``calc_phore_fitting`` command line and defaults, the same score-file
column map, and ``generate_complex_phore`` on the port's
``chem/complex_phore.py``.  The scorer on the card is ``ops/fitscore.py``;
this bridge scores pose files on the host for file-level interoperability.

The CLI is compiled from ``native/ancphore_cli/ancphore.cpp`` with the
Makefile's flags into ``build/ancphore/`` in the checkout, under a name that
carries a hash of the source and flags, so an edited source is rebuilt and a
built one reused.  Nothing is written under ``native/``.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from typing import Optional

from .logging import log_error, log_warn

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SOURCE = os.path.join(_ROOT, "native", "ancphore_cli", "ancphore.cpp")
BUILD_DIR = os.path.join(_ROOT, "build", "ancphore")
CXX_FLAGS = ["-O2", "-std=c++17"]

_FITNESS_INDEX = {1: -4, 2: -3, 3: -2, 4: -1, 5: -5, 6: -6}
_lock = threading.Lock()


def binary_path() -> str:
    """Where the CLI built from ``SOURCE`` lives: ``build/ancphore/ancphore_<hash>``."""
    try:
        with open(SOURCE, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    except OSError:
        return os.path.join(BUILD_DIR, "ancphore")
    return os.path.join(BUILD_DIR, f"ancphore_{digest}")


#: the default binary: the CLI built from the checkout's source
ANCPHORE = binary_path()


def ensure_built(path: str = ANCPHORE) -> Optional[str]:
    """The CLI to run: ``path`` when it names another binary that exists,
    else the one built from ``native/ancphore_cli/ancphore.cpp`` (compiled
    with g++ if it is not built yet).  None, logged, when neither is there."""
    if path != ANCPHORE:
        if os.path.exists(path):
            return path
        log_warn(f"ancphore CLI not found at {path}")
        return None
    with _lock:
        out = binary_path()
        if os.path.exists(out):
            return out
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        try:
            subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SOURCE],
                           check=True, capture_output=True)
            os.replace(tmp, out)
        except (OSError, subprocess.CalledProcessError) as e:
            log_warn(f"Could not build ancphore CLI: {e}")
            if os.path.exists(tmp):
                os.remove(tmp)
            return None
        return out


def parse_score_file(score_file: str, return_all: bool = False, fitness: int = 1):
    """The scores of a score file's rows: the column of ``fitness`` (1-4
    PhScore1-4, 5 the target-fishing score, 6 the custom fitness; -4 for any
    other), or with ``return_all`` the five columns [-6:-1].  None, logged,
    when the file cannot be read or parsed."""
    try:
        with open(score_file) as f:
            lines = [line.strip().split("\t") for line in f]
        if return_all:
            return [[float(x) for x in row[-6:-1]] for row in lines]
        idx = _FITNESS_INDEX.get(fitness, -4)
        return [float(row[idx]) for row in lines]
    except (OSError, ValueError, IndexError) as e:
        log_error(f"Failed to parse the score file {score_file}: {e}")
        return None


def calc_phore_fitting(
    ligand_file: str,
    phore_file: str,
    score_file: str,
    dbphore_file: str = "",
    log_file: str = "",
    overwrite: bool = False,
    return_all: bool = False,
    exVolume_cutoff: float = 500,
    overlap_coeff: float = -1,
    percent_coeff: float = -1,
    anchor_coeff: float = -1,
    ancphore_path: str = ANCPHORE,
    target_fishing: bool = False,
    fitness: int = 1,
    timeout: float = 200.0,
):
    """Score a (multi-)pose SDF against a reference pharmacophore file with
    the CLI; an existing ``score_file`` is read unless ``overwrite``."""
    fitness = 5 if target_fishing else fitness
    binary = ensure_built(ancphore_path)
    if binary is None:
        return None
    if not os.path.exists(score_file) or overwrite:
        cmd = [binary, "-d", ligand_file, "--refphore", phore_file,
               "--scores", score_file, "usedMultiConformerFile", "formodel"]
        if exVolume_cutoff != 500:
            cmd += ["--exvolume_cutoff", str(exVolume_cutoff)]
        if overlap_coeff != -1:
            cmd += ["--overlap_coeff", str(overlap_coeff)]
        if percent_coeff != -1:
            cmd += ["--percent_coeff", str(percent_coeff)]
        if anchor_coeff != -1:
            cmd += ["--anchor_coeff", str(anchor_coeff)]
        try:
            result = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
            if log_file:
                with open(log_file, "w") as f:
                    f.write(result.stdout + result.stderr)
            if result.returncode != 0:
                log_error(f"ancphore failed ({result.returncode}): {result.stderr[:500]}")
        except subprocess.TimeoutExpired:
            log_error(f"ancphore timed out after {timeout}s for {ligand_file}")
            return None
    if not os.path.exists(score_file):
        log_error(f"No score file generated for {ligand_file}")
        return None
    return parse_score_file(score_file, return_all=return_all, fitness=fitness)


def generate_complex_phore(
    ligand_file: str,
    protein_file: str,
    pdb_id: str,
    tmp_dir: str = "data/complex_phores",
    ancphore_path: str = ANCPHORE,
) -> str:
    """Write ``{tmp_dir}/complex_phores/{pdb_id}_complex.phore`` from a bound
    complex (``chem/complex_phore.py``; an existing file is kept) and return
    its text, or "" when it could not be made.  ``ancphore_path`` is unused:
    the CLI does not generate pharmacophores."""
    out_file = os.path.join(tmp_dir, f"complex_phores/{pdb_id}_complex.phore")
    os.makedirs(os.path.dirname(out_file), exist_ok=True)
    if not os.path.exists(out_file):
        try:
            from ..chem.complex_phore import generate_complex_phore as _gen
            from ..chem.sdf import read_molecule

            mol = read_molecule(ligand_file, remove_hs=True)
            if mol is None:
                raise ValueError(f"could not read ligand {ligand_file}")
            _gen(protein_file, mol, out_file=out_file,
                 name=f"{pdb_id}_complex", overwrite=False)
        except Exception as e:  # noqa: BLE001 - logged, and "" returned
            log_error(f"complex phore generation failed for {pdb_id}: {e}")
    if os.path.exists(out_file):
        with open(out_file) as f:
            return f.read()
    return ""

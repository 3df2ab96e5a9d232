"""Small host utilities: text lists, YAML dumps of settings, host seeding,
a SIGALRM time limit and an RMSD bridge to OpenBabel's ``obrms``.

The port's copy of ``diffphore_tpu.utils.misc``: :func:`save_yaml_file`
writes through :mod:`.flat_yaml` the text ``yaml.safe_dump(..., sort_keys=True)``
writes for the CLIs' settings (scalars and lists of scalars)."""

from __future__ import annotations

import contextlib
import random
import shutil
import signal
import subprocess
from typing import List, Optional

import numpy as np

from . import flat_yaml


def read_strings_from_txt(path: str) -> List[str]:
    """Non-empty stripped lines."""
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def save_yaml_file(path: str, content) -> None:
    """A dict, a list or an ``argparse.Namespace`` of scalars and lists of
    scalars as YAML, keys sorted."""
    if not isinstance(content, (dict, list)):
        content = vars(content)
    with open(path, "w") as f:
        f.write(flat_yaml.dumps(content))


def set_seed(seed: int) -> None:
    """Seed Python's and numpy's global generators, which host featurization
    draws from.  Torch is not seeded: the port passes explicit generators."""
    random.seed(seed)
    np.random.seed(seed)


@contextlib.contextmanager
def time_limit(seconds: float):
    """Raise ``TimeoutError`` in the block after ``seconds`` (SIGALRM, main
    thread only)."""

    def handler(signum, frame):
        raise TimeoutError(f"Timed out after {seconds}s")

    old = signal.signal(signal.SIGALRM, handler)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def get_obrmsd(ref_file: str, pose_file: str, obrms_binary: str = "obrms") -> Optional[List[float]]:
    """RMSD of each pose in ``pose_file`` to the first molecule of
    ``ref_file``: OpenBabel's ``obrms`` when it is on PATH, else the
    symmetry-corrected RMSD of the heavy atoms (poses of another atom count
    left out)."""
    if shutil.which(obrms_binary):
        try:
            out = subprocess.run([obrms_binary, ref_file, pose_file],
                                 capture_output=True, text=True, timeout=300)
            return [float(line.split()[-1]) for line in out.stdout.splitlines() if line.strip()]
        except (subprocess.SubprocessError, ValueError, OSError):
            return None
    from ..chem.rmsd import symmetry_rmsd
    from ..chem.sdf import parse_sdf

    ref = parse_sdf(ref_file)
    poses = parse_sdf(pose_file)
    if not ref or not poses:
        return None
    r = ref[0].remove_hs()
    out = []
    for p in poses:
        p = p.remove_hs()
        if p.num_atoms == r.num_atoms:
            out.append(symmetry_rmsd(r, r.coords, p.coords))
    return out

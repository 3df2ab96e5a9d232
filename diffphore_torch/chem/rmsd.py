"""Pose RMSD without symmetry correction."""

from __future__ import annotations

import numpy as np


def plain_rmsd(coords_a: np.ndarray, coords_b: np.ndarray) -> float:
    """RMSD of two (A, 3) coordinate sets in one frame, atom i against atom i."""
    return float(np.sqrt(((coords_a - coords_b) ** 2).sum(-1).mean()))

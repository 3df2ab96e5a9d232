"""Conformer matching: fit a generated conformer's torsions to ground truth.

The port's copy of ``diffphore_tpu.chem.conformer_matching`` (numpy and
scipy on the host).

Torsional-Diffusion-style matching (reference conformer_matching.py:16-196):
optimize the rotatable-bond dihedrals of an embedded conformer to minimize
aligned RMSD against the experimental pose, with scipy differential
evolution.  Used by the training dataset when ``matching=True`` so the model
learns from poses whose local geometry comes from the conformer generator,
not the crystal.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
from scipy.optimize import differential_evolution
from scipy.spatial.transform import Rotation

from .mol import Molecule
from .topology import rotatable_bonds, torsion_dihedral_atoms


def get_dihedral(coords: np.ndarray, a: int, b: int, c: int, d: int) -> float:
    """Signed dihedral angle a-b-c-d in radians."""
    b0 = coords[a] - coords[b]
    b1 = coords[c] - coords[b]
    b2 = coords[d] - coords[c]
    b1 = b1 / (np.linalg.norm(b1) + 1e-12)
    v = b0 - np.dot(b0, b1) * b1
    w = b2 - np.dot(b2, b1) * b1
    x = np.dot(v, w)
    y = np.dot(np.cross(b1, v), w)
    return float(np.arctan2(y, x))


def set_dihedral(
    coords: np.ndarray, quad: Tuple[int, int, int, int],
    mask_rotate: np.ndarray, angle: float,
) -> np.ndarray:
    """Rotate the moving side around bond (b, c) so dihedral a-b-c-d == angle."""
    a, b, c, d = quad
    current = get_dihedral(coords, a, b, c, d)
    delta = angle - current
    axis = coords[c] - coords[b]
    axis = axis / (np.linalg.norm(axis) + 1e-12)
    R = Rotation.from_rotvec(axis * delta).as_matrix()
    out = coords.copy()
    out[mask_rotate] = (out[mask_rotate] - coords[c]) @ R.T + coords[c]
    return out


def aligned_rmsd(a: np.ndarray, b: np.ndarray) -> float:
    """RMSD after optimal rigid alignment (Kabsch, scipy)."""
    ac, bc = a - a.mean(0), b - b.mean(0)
    rot, _ = Rotation.align_vectors(bc, ac)
    return float(np.sqrt(((ac @ rot.as_matrix().T - bc) ** 2).sum(-1).mean()))


def optimize_rotatable_bonds(
    mol: Molecule,
    true_coords: np.ndarray,
    popsize: int = 15,
    maxiter: int = 15,
    seed: int = 0,
) -> float:
    """In-place torsion fit of mol.coords to true_coords.

    Returns the final aligned RMSD.  No-op for rigid molecules.
    """
    quads = torsion_dihedral_atoms(mol)
    edges, masks = rotatable_bonds(mol)
    if not quads:
        return aligned_rmsd(mol.coords, true_coords)
    # map each dihedral quad to its rotation mask (same bond order)
    quad_masks = []
    edge_list = [tuple(e) for e in edges.tolist()]
    for a, b, c, d in quads:
        idx = edge_list.index((b, c)) if (b, c) in edge_list else edge_list.index((c, b))
        quad_masks.append(masks[idx])

    base = mol.coords.copy()

    def apply(angles: Sequence[float]) -> np.ndarray:
        coords = base.copy()
        for quad, m, ang in zip(quads, quad_masks, angles):
            coords = set_dihedral(coords, quad, m, ang)
        return coords

    def objective(angles: np.ndarray) -> float:
        return aligned_rmsd(apply(angles), true_coords)

    bounds = [(-np.pi, np.pi)] * len(quads)
    result = differential_evolution(
        objective, bounds, popsize=popsize, maxiter=maxiter, seed=seed, tol=0.01,
        polish=False,
    )
    mol.coords = apply(result.x)
    return float(result.fun)

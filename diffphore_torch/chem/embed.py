"""3D conformer embedding for topology-only inputs (SMILES).

Replaces RDKit ETKDGv2 + MMFF (DiffPhore's generate_conformer,
process_mols.py:287-306) with a light distance-geometry + force-field
refinement: covalent-radius bond lengths, hybridization-based angles,
aromatic-ring planarity and a soft nonbonded repulsion, minimized with
scipy L-BFGS from a spectral initialization.

Quality target: locally correct chemistry (bonds/angles/ring shapes).  The
diffusion sampler randomizes all torsions anyway, so global conformation is
irrelevant at inference time; for training-with-matching the conformer is
further optimized against the ground truth by conformer_matching.
"""

from __future__ import annotations

import numpy as np

from . import graph
from .mol import AROMATIC_BOND, Molecule

_COV_RADII = {
    1: 0.31, 5: 0.84, 6: 0.76, 7: 0.71, 8: 0.66, 9: 0.57, 14: 1.11, 15: 1.07,
    16: 1.05, 17: 1.02, 34: 1.2, 35: 1.2, 53: 1.39,
}


def _bond_length(z1: int, z2: int, order: int) -> float:
    base = _COV_RADII.get(z1, 1.1) + _COV_RADII.get(z2, 1.1)
    if order == 2:
        return base * 0.87
    if order == 3:
        return base * 0.78
    if order == AROMATIC_BOND:
        return base * 0.91
    return base


def _ideal_angle(mol: Molecule, center: int) -> float:
    h = mol.hybridization(center)
    if h == "SP":
        return np.pi
    if h == "SP2":
        return np.deg2rad(120.0)
    return np.deg2rad(109.5)


def embed_molecule(mol: Molecule, seed: int = 0, max_iter: int = 400) -> np.ndarray:
    """Generate 3D coordinates for a heavy-atom molecular graph in place."""
    from scipy.optimize import minimize

    n = mol.num_atoms
    rng = np.random.default_rng(seed)
    if n == 1:
        mol.coords = np.zeros((1, 3))
        return mol.coords

    # spring-layout 3D init + jitter (avoids the collinear failure mode)
    init = graph.spring_layout(graph.from_bonds(n, mol.bonds), dim=3, seed=seed)
    x0 = np.asarray([init[i] for i in range(n)]) * 1.5 * np.sqrt(n)
    x0 += rng.normal(scale=0.1, size=x0.shape)

    bond_terms = [
        (i, j, _bond_length(mol.atoms[i].atomic_num, mol.atoms[j].atomic_num, o))
        for i, j, o in mol.bonds
    ]
    angle_terms = []
    for c in range(n):
        nbrs = mol.neighbors[c]
        theta = _ideal_angle(mol, c)
        for a in range(len(nbrs)):
            for b in range(a + 1, len(nbrs)):
                i, j = nbrs[a], nbrs[b]
                d_ij = np.sqrt(
                    _bond_length(mol.atoms[i].atomic_num, mol.atoms[c].atomic_num, 1) ** 2
                    + _bond_length(mol.atoms[j].atomic_num, mol.atoms[c].atomic_num, 1) ** 2
                    - 2
                    * _bond_length(mol.atoms[i].atomic_num, mol.atoms[c].atomic_num, 1)
                    * _bond_length(mol.atoms[j].atomic_num, mol.atoms[c].atomic_num, 1)
                    * np.cos(theta)
                )
                angle_terms.append((i, j, d_ij))
    arom_rings = [r for r in mol.sssr if all(mol.atoms[i].is_aromatic for i in r)]
    bonded = {(min(i, j), max(i, j)) for i, j, _ in mol.bonds}
    one_three = {(min(i, j), max(i, j)) for i, j, _ in angle_terms}

    bi = np.asarray([[i, j] for i, j, _ in bond_terms], int).reshape(-1, 2)
    bl = np.asarray([d for _, _, d in bond_terms])
    ai = np.asarray([[i, j] for i, j, _ in angle_terms], int).reshape(-1, 2)
    al = np.asarray([d for _, _, d in angle_terms])
    nb_pairs = np.asarray(
        [
            (i, j)
            for i in range(n)
            for j in range(i + 1, n)
            if (i, j) not in bonded and (i, j) not in one_three
        ],
        int,
    ).reshape(-1, 2)

    def energy(flat: np.ndarray) -> float:
        x = flat.reshape(n, 3)
        e = 0.0
        if len(bi):
            d = np.linalg.norm(x[bi[:, 0]] - x[bi[:, 1]], axis=1)
            e += 50.0 * np.sum((d - bl) ** 2)
        if len(ai):
            d = np.linalg.norm(x[ai[:, 0]] - x[ai[:, 1]], axis=1)
            e += 20.0 * np.sum((d - al) ** 2)
        if len(nb_pairs):
            d = np.linalg.norm(x[nb_pairs[:, 0]] - x[nb_pairs[:, 1]], axis=1)
            e += np.sum(np.maximum(2.6 - d, 0.0) ** 2) * 10.0
        for ring in arom_rings:
            pts = x[ring] - x[ring].mean(0)
            # planarity: smallest singular value of the centered ring coords
            s = np.linalg.svd(pts, compute_uv=False)
            e += 30.0 * s[-1] ** 2
        return e

    res = minimize(energy, x0.ravel(), method="L-BFGS-B", options={"maxiter": max_iter})
    coords = res.x.reshape(n, 3)
    mol.coords = coords - coords.mean(0)
    return mol.coords

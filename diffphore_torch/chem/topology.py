"""Torsion topology: rotatable-bond detection and rotation masks.

Equivalent of reference get_transformation_mask (utils/torsion.py:13-61): a
bond is rotatable iff deleting it disconnects the graph into two components
each containing > 1 atom; the smaller component is the side that rotates, and
the bond is oriented (u, v) with v inside the rotating side.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from . import graph
from .mol import Molecule


def rotatable_bonds(mol: Molecule) -> Tuple[np.ndarray, np.ndarray]:
    """Find rotatable bonds of a (heavy-atom) molecule.

    Returns:
      tor_edges: (T, 2) int array of (u, v) atom indices, v on the moving side.
      mask_rotate: (T, num_atoms) bool - atoms moved when that bond rotates.
    """
    adj = graph.from_bonds(mol.num_atoms, mol.bonds)

    edges: List[Tuple[int, int]] = []
    masks: List[np.ndarray] = []
    for i, j, _ in mol.bonds:
        cut = graph.without_edge(adj, i, j)
        if graph.is_connected(cut):
            continue
        # stable sort: between two equal sides the one discovered first
        # (holding the lowest atom index) rotates
        comps = sorted(graph.connected_components(cut), key=len)
        small = comps[0]
        if len(small) <= 1:
            continue
        u, v = (i, j) if j in small else (j, i)
        m = np.zeros(mol.num_atoms, dtype=bool)
        m[list(small)] = True
        edges.append((u, v))
        masks.append(m)
    if not edges:
        return np.zeros((0, 2), dtype=np.int32), np.zeros((0, mol.num_atoms), dtype=bool)
    return np.asarray(edges, dtype=np.int32), np.stack(masks)


def torsion_dihedral_atoms(mol: Molecule) -> List[Tuple[int, int, int, int]]:
    """(a, b, c, d) dihedral quadruples for each rotatable bond (b, c).

    Used by conformer matching (reference conformer_matching.py:64-183 picks
    one neighbor on each side).
    """
    edges, _ = rotatable_bonds(mol)
    out = []
    for u, v in edges:
        a = next((k for k in mol.neighbors[u] if k != v), None)
        d = next((k for k in mol.neighbors[v] if k != u), None)
        if a is not None and d is not None:
            out.append((a, int(u), int(v), d))
    return out

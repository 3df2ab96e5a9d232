"""Pose RMSD, plain and symmetry-corrected.

:func:`symmetry_rmsd` is the port's copy of ``diffphore_tpu.chem.rmsd``'s:
the automorphisms of the (element, bond-order) coloured molecular graph,
enumerated by :func:`.graph.isomorphisms_iter` (networkx's VF2 restated,
mappings in networkx's sequence), the minimum RMSD over the first
``max_mappings`` of them.  The cap makes the order part of the result on a
ligand with more automorphisms than that.
"""

from __future__ import annotations

import numpy as np

from .graph import add_edge, isomorphisms_iter
from .mol import Molecule


def _graph(mol: Molecule):
    """(adjacency, node attributes) as the JAX package's networkx graph:
    atoms in order with their atomic number, then the bonds in order with
    their order."""
    nodes = {i: {"z": a.atomic_num} for i, a in enumerate(mol.atoms)}
    adj = {i: {} for i in nodes}
    for i, j, o in mol.bonds:
        add_edge(adj, i, j, o=o)
    return adj, nodes


def _node_match(d1, d2) -> bool:
    return d1.get("z", 0) == d2.get("z", 0)


def _edge_match(e1, e2) -> bool:
    return e1.get("o", 0) == e2.get("o", 0)


def symmetry_rmsd(
    mol: Molecule,
    coords_a: np.ndarray,
    coords_b: np.ndarray,
    max_mappings: int = 256,
    align: bool = False,
) -> float:
    """Min RMSD between two coordinate sets over graph automorphisms.

    ``align=False`` matches the docking convention (poses share a frame).
    """
    adj, nodes = _graph(mol)
    best = np.inf
    n = len(mol.atoms)
    count = 0
    for mapping in isomorphisms_iter(adj, adj, nodes, nodes, _node_match, _edge_match):
        perm = np.asarray([mapping[i] for i in range(n)])
        b = coords_b[perm]
        if align:
            from scipy.spatial.transform import Rotation

            ac = coords_a - coords_a.mean(0)
            bc = b - b.mean(0)
            rot, _ = Rotation.align_vectors(ac, bc)
            b = bc @ rot.as_matrix().T + coords_a.mean(0)
        rmsd = float(np.sqrt(((coords_a - b) ** 2).sum(-1).mean()))
        best = min(best, rmsd)
        count += 1
        if count >= max_mappings:
            break
    return best


def plain_rmsd(coords_a: np.ndarray, coords_b: np.ndarray) -> float:
    """RMSD of two (A, 3) coordinate sets in one frame, atom i against atom i."""
    return float(np.sqrt(((coords_a - coords_b) ** 2).sum(-1).mean()))

"""Categorical atom featurization for the score network.

Vocabulary layout matches the reference's 16-dim featurizer exactly
(lig_atom_featurizer + lig_feature_dims, process_mols.py:127-244) so model
configs carry over: [atomic_num(119), chirality(4), total_degree(12),
formal_charge(12), implicit_valence(8), total_num_h(10), radical_e(5),
hybridization(6), is_aromatic(2), num_rings(8), in_ring3..8(2 each)].

Documented deviation: chirality is always CHI_UNSPECIFIED (index 0) and
radical electrons always 0 - neither is perceived by the host chem kernel,
and neither influences the reference's shipped pipeline for typical inputs.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .mol import Molecule

#: categorical vocabulary sizes, in featurizer column order
LIG_FEATURE_DIMS: List[int] = [119, 4, 12, 12, 8, 10, 5, 6, 2, 8, 2, 2, 2, 2, 2, 2]
#: number of scalar features appended after the categoricals
LIG_NUM_SCALAR_FEATURES = 0

_HYBRID = {"SP": 0, "SP2": 1, "SP3": 2, "SP3D": 3, "SP3D2": 4}
_CHARGES = list(range(-5, 6))


def _clip_index(value: int, size: int) -> int:
    """safe_index semantics: out-of-vocabulary -> last index ('misc')."""
    return value if 0 <= value < size - 1 else size - 1


def featurize_atoms(mol: Molecule) -> np.ndarray:
    """(num_atoms, 16) int32 categorical feature matrix."""
    rows = []
    for i, a in enumerate(mol.atoms):
        z_idx = a.atomic_num - 1 if 1 <= a.atomic_num <= 118 else 118
        charge_idx = _CHARGES.index(a.charge) if a.charge in _CHARGES else 11
        rows.append(
            [
                z_idx,
                0,  # chirality: CHI_UNSPECIFIED
                _clip_index(mol.total_degree(i), 12),
                charge_idx,
                _clip_index(mol.implicit_h_count(i), 8),
                _clip_index(mol.total_h_count(i), 10),
                0,  # radical electrons
                _HYBRID.get(mol.hybridization(i), 5),
                int(a.is_aromatic),
                _clip_index(mol.num_atom_rings(i), 8),
                int(mol.is_atom_in_ring_of_size(i, 3)),
                int(mol.is_atom_in_ring_of_size(i, 4)),
                int(mol.is_atom_in_ring_of_size(i, 5)),
                int(mol.is_atom_in_ring_of_size(i, 6)),
                int(mol.is_atom_in_ring_of_size(i, 7)),
                int(mol.is_atom_in_ring_of_size(i, 8)),
            ]
        )
    return np.asarray(rows, dtype=np.int32)


#: bond-type one-hot channels: single, double, triple, aromatic
BOND_TYPES = {1: 0, 2: 1, 3: 2, 4: 3}
NUM_BOND_FEATURES = 4


def bond_features(order: int) -> np.ndarray:
    from .mol import AROMATIC_BOND

    vec = np.zeros(NUM_BOND_FEATURES, dtype=np.float32)
    vec[BOND_TYPES.get(4 if order == AROMATIC_BOND else order, 0)] = 1.0
    return vec

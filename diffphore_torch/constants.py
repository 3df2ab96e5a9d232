"""Chemistry constants the model and the fitness scorer consume.

The port keeps its own copies so that it runs without the JAX package; a
test holds each one equal to its counterpart there.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

#: categorical vocabulary sizes of the 16 ligand atom-feature columns
#: [atomic_num, chirality, degree, formal_charge, implicit_valence, num_h,
#:  radical_e, hybridization, is_aromatic, num_rings, in_ring3..8]
LIG_FEATURE_DIMS: List[int] = [119, 4, 12, 12, 8, 10, 5, 6, 2, 8, 2, 2, 2, 2, 2, 2]

#: pharmacophore feature types; EX (exclusion volume) is last
PHORETYPES = ["MB", "HD", "AR", "PO", "HA", "HY", "NE", "CV", "CR", "XB", "EX"]
NUM_PHORETYPE = len(PHORETYPES)

#: per-type interaction weight and Gaussian alpha of the fitness scorer
PHORE_WEIGHT = [1.5, 1.2, 1.0, 1.5, 1.2, 0.5, 1.5, 1.0, 1.0, 1.0, 1.0]
PHORE_ALPHA = [1.0, 1.0, 0.7, 1.0, 1.0, 0.7, 1.0, 1.0, 0.7, 1.0, 0.837]

#: phore node featurizer: categorical vocab sizes (type, is_EX, has_norm)
#: and the number of trailing scalars (alpha, weight)
PHORE_FEATURE_DIMS = ([NUM_PHORETYPE, 2, 2], 2)

#: van-der-Waals radii (Angstrom) by atomic number; 1.7 for the rest
_VDW: Dict[int, float] = {
    1: 1.2, 5: 1.92, 6: 1.7, 7: 1.55, 8: 1.52, 9: 1.47, 14: 2.1, 15: 1.8,
    16: 1.8, 17: 1.75, 34: 1.9, 35: 1.85, 53: 1.98,
}


def vdw_radius(z: int) -> float:
    return _VDW.get(z, 1.7)


#: radii indexed by the atomic-number feature column (atomic_num - 1)
VDW_TABLE = np.asarray([vdw_radius(z) for z in range(1, 120)], np.float32)

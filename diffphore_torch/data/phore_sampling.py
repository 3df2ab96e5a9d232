"""Random pharmacophore generation from ligands.

The port's copy of ``diffphore_tpu.data.phore_sampling``: every draw comes
from one ``np.random.default_rng(seed)`` in the same order, so a seed gives
the JAX package's phore bit for bit.

Used by ligand-only training modes (ZINC/ChEMBL) and the baseline drivers:
sample a sub-pharmacophore from a ligand's perceived features and surround it
with synthetic exclusion volumes.  Semantics follow the reference
(process_pharmacophore.py:187-298, 335-430): cluster-based feature sampling,
radius/shell EX placement with clash rejection, optional surface filtering.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..chem.mol import Molecule
from ..chem.pharmacophore_rules import PHORETYPES, ligand_phore_features
from ..constants import PHORE_ALPHA, PHORE_WEIGHT
from .phore import Phore, PhoreFeature


def phore_from_ligand(
    mol: Molecule, name: str = "ligand_phore", rng: Optional[np.random.Generator] = None
) -> Phore:
    """Perceive a full ligand-based pharmacophore (one feature per atom-type flag)."""
    fp, norms, _, _, _ = ligand_phore_features(mol)
    feats: List[PhoreFeature] = []
    for i in range(mol.num_atoms):
        for t_idx, t in enumerate(PHORETYPES):
            if t == "EX" or fp[i, t_idx] == 0:
                continue
            coord = tuple(float(x) for x in mol.coords[i])
            norm_pt = tuple(float(x) for x in (mol.coords[i] + norms[i, t_idx]))
            has_norm = bool(np.linalg.norm(norms[i, t_idx]) > 1e-6)
            feats.append(
                PhoreFeature(
                    type=t, alpha=PHORE_ALPHA[t_idx], weight=PHORE_WEIGHT[t_idx],
                    factor=1.0, coord=coord, has_norm=has_norm, norm=norm_pt,
                )
            )
    return Phore(name, feats, [])


def _clusters(phore: Phore, epsilon: float = 1e-6) -> List[List[PhoreFeature]]:
    """Group co-located features (reference add_phore_to_cluster :155-184)."""
    clusters: List[Tuple[np.ndarray, List[PhoreFeature]]] = []
    for f in phore.all_points:
        c = np.asarray(f.coord)
        for center, members in clusters:
            if np.linalg.norm(center - c) <= epsilon:
                members.append(f)
                break
        else:
            clusters.append((c, [f]))
    return [m for _, m in clusters]


def extract_random_phore(
    phore: Phore,
    up_num: int = 8,
    low_num: int = 4,
    sample_num: int = 10,
    max_rounds: int = 100,
    rng: Optional[np.random.Generator] = None,
) -> List[Phore]:
    """Sample distinct sub-pharmacophores by picking 1 feature per cluster."""
    rng = rng or np.random.default_rng()
    clusters = _clusters(phore)
    out: List[Phore] = []
    seen: List[frozenset] = []
    rounds = 0
    while len(out) < sample_num and rounds < max_rounds:
        rounds += 1
        num = min(int(rng.integers(low_num, max(up_num, low_num + 1))), len(clusters))
        picked = rng.choice(len(clusters), size=num, replace=False)
        feats, exs = [], []
        for ci in picked:
            f = clusters[ci][int(rng.integers(len(clusters[ci])))]
            (exs if f.type == "EX" else feats).append(f)
        key = frozenset(feats + exs)
        if key in seen or not feats:
            continue
        seen.append(key)
        out.append(Phore(f"{phore.id}_{len(out)}", feats, exs))
    return out


def _not_clashed(points: np.ndarray, others: np.ndarray, min_dist: float) -> np.ndarray:
    if len(points) == 0 or len(others) == 0:
        return points
    d = np.linalg.norm(points[:, None, :] - others[None, :, :], axis=-1)
    return points[(d > min_dist).all(axis=1)]


def generate_random_exclusion_volumes(
    phore: Phore,
    mol: Molecule,
    low: float = 3.0,
    up: float = 5.0,
    ex_dis: float = 0.8,
    num_ex: int = 5,
    near_phore: bool = True,
    cutoff: float = 2.0,
    rounds: int = 100,
    rng: Optional[np.random.Generator] = None,
) -> Phore:
    """Place synthetic EX spheres around typed ligand atoms.

    For each atom with a pharmacophore flag (optionally only those near an
    existing feature), random points at distance ~(low+up)/2 along the
    feature norm are accepted when they don't clash with ligand atoms,
    features, or previously placed EX (reference :229-298, 'radius' mode).
    """
    rng = rng or np.random.default_rng()
    fp, norms, _, _, _ = ligand_phore_features(mol)
    lig = mol.coords
    feat_coords = np.asarray([f.coord for f in phore.features]).reshape(-1, 3)
    ex: np.ndarray = np.empty((0, 3))
    if mol.num_atoms > 50:
        rounds //= 2
    for i in range(mol.num_atoms):
        if near_phore and len(feat_coords):
            d = np.linalg.norm(feat_coords - lig[i], axis=1)
            near = d < cutoff
            if not near.any():
                continue
        for t_idx in range(len(PHORETYPES) - 1):
            if fp[i, t_idx] == 0:
                continue
            center = lig[i] + norms[i, t_idx] * (low + up) / 2.0
            radius = (up - low) / 2.0
            placed = 0
            for _ in range(rounds):
                if placed >= num_ex:
                    break
                cand = (center + rng.normal(size=3) * radius).reshape(1, 3)
                cand = _not_clashed(cand, lig, low)
                cand = _not_clashed(cand, feat_coords, low)
                cand = _not_clashed(cand, ex, ex_dis)
                if len(cand):
                    ex = np.concatenate([ex, cand], axis=0)
                    placed += 1
    ex_feats = [
        PhoreFeature(type="EX", alpha=0.837, weight=0.5, factor=1.0,
                     coord=tuple(float(x) for x in p), has_norm=False,
                     norm=(0.0, 0.0, 0.0))
        for p in ex
    ]
    return Phore(phore.id, list(phore.features), ex_feats + list(phore.exclusion_volumes))


def random_ligand_phore(
    mol: Molecule,
    name: str,
    up_num: int = 8,
    low_num: int = 4,
    num_ex: int = 5,
    seed: Optional[int] = None,
) -> Optional[Phore]:
    """Full ligand-only pipeline: perceive -> subsample -> add EX shells."""
    rng = np.random.default_rng(seed)
    full = phore_from_ligand(mol, name, rng)
    if not full.features:
        return None
    subs = extract_random_phore(full, up_num, low_num, sample_num=1, rng=rng)
    if not subs:
        return None
    return generate_random_exclusion_volumes(subs[0], mol, num_ex=num_ex, rng=rng)

"""AncPhore-style lipophilicity labeling + accessible-surface hydrophobic
perception (the reference's ``follow_ancphore=True`` HY branch).

Reference: ``hy_check(mol, follow_ancphore=True)`` with its helpers
``labelLipoAtoms`` / ``labelLipoNeighbors`` / ``calAccSurf``
(DiffPhore's src/datasets/process_mols.py:553-780).  The rules are a
restatement of Pharao/align-it lipophilic-spot perception: every atom gets a
lipophilicity *factor* (1.0, attenuated to 0.6/0.25/0.15/0 around polar
centers), the factor is multiplied by the atom's solvent-accessible surface
area, and groups (rings < 7 atoms; CH3/NH3-type atoms plus their single-H
neighbors) whose summed lipophilicity exceeds 9.87 A^2 are flagged HY.

The reference branch is dead code in its own pipeline — ``analyze_phorefp``
(process_mols.py:437) always calls ``hy_check`` with the default
``follow_ancphore=False`` and no config flag reaches it — and it is broken
as written in three places.  This module implements the *intended*
semantics; the deviations are deliberate and listed here:

1. ``process_mols.py:572`` gates the surface multiply on ``float_eq(t, 0)``
   and multiplies by ``t``: only atoms whose factor is already zero are
   "updated" (to zero).  As written no atom can ever exceed the 9.87 A^2
   threshold (factors are <= 1), so the branch flags nothing.  We apply the
   evident intent: ``lipo = factor * calAccSurf(atom, 'HY')`` for heavy
   atoms with a non-zero factor.
2. ``calAccSurf`` (process_mols.py:666-674) initialises ``isAccessible``
   once *outside* the sphere-point loop, so after the first buried point
   every later point is counted inaccessible regardless of position.  We
   reset the flag per point.
3. The sulfur branch of ``labelLipoAtoms`` (process_mols.py:737) calls
   ``bond.GetOtherBonds(at)`` (a list) where an atom is required — it would
   raise if reached; the guard (``S`` with > 2 hydrogens) is chemically
   unreachable anyway.  We omit that sub-branch.

A further documented difference: the reference runs on an ``AddHs`` molecule
(explicit hydrogens block surface points and carry factor 0).  Our
``Molecule`` may hold implicit hydrogens; polar-group rules use
``total_h_count`` (equivalent), and when hydrogens are implicit the surface
calculation sees only heavy-atom blockers, which slightly raises accessible
areas.  The 9.87 A^2 threshold is kept as published.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..constants import vdw_radius
from .mol import Molecule

# Lipophilic-sum threshold (A^2) above which a ring / H-rich group is
# flagged hydrophobic (process_mols.py:583,598 — the align-it constant).
LIPO_THRESHOLD = 9.87

_EPS = 1e-6


def _sphere_points(radius: float) -> np.ndarray:
    """Quasi-uniform points on a sphere of given radius, centred at 0.

    Same spiral-layer construction as the reference ``calAccSurf``
    (process_mols.py:626-648): layers at arc-length spacing
    ``1/sqrt(2*sqrt(3))`` with alternating theta offsets.
    """
    arclength = 1.0 / np.sqrt(np.sqrt(3.0) * 2.0)
    dphi = arclength / radius
    nlayer = int(np.pi / dphi) + 1
    pts: List[List[float]] = []
    phi = 0.0
    for layer in range(nlayer):
        rsinphi = radius * np.sin(phi)
        z = radius * np.cos(phi)
        dtheta = 2.0 * np.pi if rsinphi == 0 else arclength / rsinphi
        n_pts = int(2.0 * np.pi / dtheta)
        if n_pts <= 0:
            n_pts = 1
        dtheta = 2.0 * np.pi / n_pts
        theta = 0.0 if layer % 2 else np.pi
        for _ in range(n_pts):
            pts.append([rsinphi * np.cos(theta), rsinphi * np.sin(theta), z])
            theta += dtheta
            if theta > 2.0 * np.pi:
                theta -= 2.0 * np.pi
        phi += dphi
    return np.asarray(pts)


def accessible_surface(mol: Molecule, idx: int, mode: str = "HY") -> float:
    """Solvent-accessible surface of atom ``idx``.

    Vectorised equivalent of ``calAccSurf`` (process_mols.py:605-678, with
    deviation 2 above).  ``mode='HA'`` returns the accessible *fraction* of
    points on a fixed 1.8 A sphere (probe 1.2 A); ``mode='HY'`` returns the
    accessible *area* in A^2 on the vdW sphere with points pushed out to the
    1.4 A water-probe surface.
    """
    coords = mol.coords
    center = coords[idx]
    radius = 1.8 if mode == "HA" else vdw_radius(mol.atoms[idx].atomic_num)

    rel = _sphere_points(radius)
    if mode == "HY":
        # Probe-centre surface: radial push-out by the 1.4 A probe radius.
        pts = center + rel * (1.0 + 1.4 / radius)
        probe_r = 1.4
    else:
        pts = center + rel
        probe_r = 1.2

    r_all = np.array([vdw_radius(a.atomic_num) for a in mol.atoms])
    d2 = np.sum(np.square(coords - center), axis=1)
    if mode == "HY":
        cut = np.square(radius + r_all + 2.8)
    else:
        cut = np.square(3.0 + r_all)
    near = d2 <= cut
    near[idx] = False

    if near.any():
        blockers = coords[near]
        block_r2 = np.square(r_all[near] + probe_r)
        dist2 = np.sum(
            np.square(pts[:, None, :] - blockers[None, :, :]), axis=-1
        )
        accessible = ~(dist2 <= block_r2[None, :]).any(axis=1)
        n_acc = int(accessible.sum())
    else:
        n_acc = len(pts)

    frac = n_acc / len(pts)
    if mode == "HA":
        return float(frac)
    return float(frac * 4.0 * np.pi * radius * radius)


def label_lipo_atoms(mol: Molecule) -> np.ndarray:
    """Per-atom lipophilicity factors (``labelLipoAtoms``,
    process_mols.py:684-760).

    Every atom starts at 1.0; polar centres (N, O, S-H, S=O, charged atoms)
    zero themselves and attenuate their neighbourhood multiplicatively
    (0.25 one bond out from N/O, 0.6 beyond a carbonyl/sulfonyl, 0 around
    H-bonded polar groups and charges).  The final sweep zeroes factors
    below 0.25 (and the 0.6*0.6 = 0.36 combination) except the exact 0.15
    tier, matching the reference's closing filter (:755-758).
    """
    n = mol.num_atoms
    p = np.ones(n, dtype=np.float64)

    def scale_neighbors(i: int, value: float) -> None:
        for j in mol.neighbors[i]:
            p[j] *= value

    for i, a in enumerate(mol.atoms):
        z = a.atomic_num
        if z == 1:
            p[i] = 0.0
        elif z == 7:
            p[i] = 0.0
            if not a.is_aromatic:
                scale_neighbors(i, 0.25)
                if mol.total_h_count(i) != 0:
                    # N-H: kill the whole first shell and its surroundings.
                    for j in list(mol.neighbors[i]):
                        p[j] = 0.0
                        scale_neighbors(j, 0.0)
        elif z == 8:
            p[i] = 0.0
            if not a.is_aromatic:
                scale_neighbors(i, 0.25)
                if mol.total_h_count(i) >= 1:
                    # O-H (hydroxyl): zero the first shell and its shell.
                    for j in list(mol.neighbors[i]):
                        p[j] = 0.0
                        scale_neighbors(j, 0.0)
                for j in list(mol.neighbors[i]):
                    if mol.bond_lookup[(i, j)] == 2:
                        # Carbonyl-like: zero the partner, 0.6 two bonds out.
                        p[j] = 0.0
                        for k in list(mol.neighbors[j]):
                            if k == i:
                                continue
                            p[k] = 0.0
                            scale_neighbors(k, 0.6)
        elif z == 16:
            if mol.total_h_count(i) >= 1:
                # Thiol: polar, kills its neighbourhood.
                p[i] = 0.0
                scale_neighbors(i, 0.0)
            for j in list(mol.neighbors[i]):
                if mol.bond_lookup[(i, j)] == 2:
                    # S=O / S=C: sulfur polar, 0.6 one bond out (applied per
                    # double bond, so sulfones reach 0.36 -> filtered to 0).
                    p[i] = 0.0
                    scale_neighbors(i, 0.6)

        if a.charge != 0:
            for j in list(mol.neighbors[i]):
                p[j] = 0.0
                scale_neighbors(j, 0.0)

    for i in range(n):
        v = p[i]
        if (abs(v - 0.36) <= _EPS or v < 0.25) and abs(v - 0.15) > _EPS:
            p[i] = 0.0
    return p


def hy_check_ancphore(mol: Molecule) -> np.ndarray:
    """AncPhore-rule hydrophobic flags (``hy_check`` with
    ``follow_ancphore=True``, process_mols.py:564-600; deviations 1-3 in the
    module docstring).

    Per-atom lipophilicity = factor * accessible surface (A^2).  Rings with
    < 7 atoms whose summed lipophilicity exceeds :data:`LIPO_THRESHOLD` are
    flagged; so are CH3/NH3-type atoms (> 2 hydrogens) together with their
    single-hydrogen heavy neighbours when the group sum exceeds it.
    Requires a conformer (``mol.coords``).
    """
    n = mol.num_atoms
    factors = label_lipo_atoms(mol)
    lipo = np.zeros(n, dtype=np.float64)
    for i, a in enumerate(mol.atoms):
        if a.atomic_num != 1 and factors[i] > 0.0:
            lipo[i] = factors[i] * accessible_surface(mol, i, "HY")

    hy = np.zeros(n, dtype=bool)
    remaining = set(range(n))
    for ring in mol.sssr:
        if len(ring) < 7:
            ring_sum = float(sum(lipo[k] for k in ring))
            remaining.difference_update(ring)
            if ring_sum > LIPO_THRESHOLD:
                for k in ring:
                    hy[k] = True

    for i in sorted(remaining):
        if mol.atoms[i].atomic_num == 1 or mol.total_h_count(i) <= 2:
            continue
        group = [i]
        group_sum = lipo[i]
        for j in mol.neighbors[i]:
            if mol.atoms[j].atomic_num != 1 and mol.total_h_count(j) == 1:
                group_sum += lipo[j]
                group.append(j)
        if group_sum > LIPO_THRESHOLD:
            for k in group:
                hy[k] = True
    return hy

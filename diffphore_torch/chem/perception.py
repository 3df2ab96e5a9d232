"""Aromaticity perception for kekulized structures (SDF/MOL inputs).

SDF files write aromatic rings as alternating single/double (Kekule) bonds;
the featurizer and pharmacophore rules need aromatic flags (the reference gets
them from RDKit sanitization).  We apply a Hueckel-style rule over SSSR rings
and fused ring pairs:

  * every ring atom must be sp2-capable (C/N/O/S/P/B/Se/As, not sp3-saturated)
  * pi electrons: 1 for an atom with a double bond inside the ring system,
    0 for an atom whose only double bond is exocyclic (e.g. quinone C=O),
    2 for a heteroatom contributing a lone pair (pyrrole N, furan O,
    thiophene S), 0 for a carbocation
  * ring aromatic iff the pi count satisfies 4n+2

This covers the drug-like chemistry the pipeline sees; documented deviation:
no "extended" aromaticity over arbitrary fused envelopes beyond ring pairs.
"""

from __future__ import annotations

from typing import List, Set, Tuple

from .mol import AROMATIC_BOND, Molecule

_SP2_CAPABLE = {5, 6, 7, 8, 15, 16, 33, 34}


def _ring_pi_electrons(mol: Molecule, ring: List[int]) -> int | None:
    """Pi electron count of a candidate ring, or None if not aromatizable."""
    ring_set = set(ring)
    total = 0
    for i in ring:
        a = mol.atoms[i]
        z = a.atomic_num
        if z not in _SP2_CAPABLE:
            return None
        double_in = 0
        double_out = 0
        for j in mol.neighbors[i]:
            o = mol.bond_lookup[(i, j)]
            if o == 2 or o == AROMATIC_BOND:
                if j in ring_set:
                    double_in += 1
                else:
                    double_out += 1
        if double_in >= 1:
            total += 1
        elif double_out:
            # exocyclic double bond (C=O of quinone): contributes 0 pi
            # electrons but stays sp2 -> ring can still be aromatic (tropone)
            total += 0
        else:
            # saturated ring member: heteroatom lone pair or blocked carbon
            if z in (7, 15):  # N/P with H or substituent: lone pair in ring
                total += 2
            elif z in (8, 16, 34):  # O/S/Se ethers in ring
                total += 2
            elif z == 6:
                if a.charge == 1:
                    total += 0  # tropylium
                elif a.charge == -1:
                    total += 2  # cyclopentadienyl
                else:
                    return None  # sp3 carbon blocks aromaticity
            else:
                return None
    return total


def perceive_aromaticity(mol: Molecule) -> None:
    """Set atom/bond aromatic flags in place from Kekule structure."""
    rings = mol.sssr
    aromatic_rings: List[List[int]] = []
    # single rings
    for ring in rings:
        if len(ring) < 5 or len(ring) > 7:
            continue
        pi = _ring_pi_electrons(mol, ring)
        if pi is not None and pi % 4 == 2:
            aromatic_rings.append(ring)
    # fused pairs (naphthalene-style envelopes where individual Kekule rings
    # already pass are common; pairs catch azulene-likes)
    for a_idx in range(len(rings)):
        for b_idx in range(a_idx + 1, len(rings)):
            ra, rb = set(rings[a_idx]), set(rings[b_idx])
            if len(ra & rb) == 2:
                merged = list(ra | rb)
                pi = _ring_pi_electrons(mol, merged)
                if pi is not None and pi % 4 == 2:
                    aromatic_rings.append(merged)

    arom_atoms: Set[int] = set()
    for ring in aromatic_rings:
        arom_atoms.update(ring)
    for i in arom_atoms:
        mol.atoms[i].is_aromatic = True
    # flag ring bonds between aromatic atoms of the same aromatic ring
    arom_bonds: Set[Tuple[int, int]] = set()
    for ring in aromatic_rings:
        rs = set(ring)
        for i, j, _ in mol.bonds:
            if i in rs and j in rs and mol.bond_in_ring(i, j):
                arom_bonds.add((i, j))
    new_bonds = []
    for i, j, o in mol.bonds:
        if (i, j) in arom_bonds:
            new_bonds.append((i, j, AROMATIC_BOND))
        else:
            new_bonds.append((i, j, o))
    mol.bonds = new_bonds
    mol.invalidate()

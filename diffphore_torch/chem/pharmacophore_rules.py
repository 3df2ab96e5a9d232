"""Pharmacophore-type perception: rule equivalents of the reference's SMARTS
table (PHORE_SMARTS, DiffPhore's src/datasets/process_mols.py:35-123).

No SMARTS engine exists in this environment (no RDKit), so each pattern family
is restated as an explicit graph rule over the Molecule model.  The 11 types
and their per-atom flag semantics match `check_atom_phoretype` /
`phore_check`; molecule-level counts match the `_<TYPE>` properties consumed
by `get_perfect_similarity` (inference.py:273-312):

  MB metal binder | HD H-bond donor | AR aromatic | PO positive | HA acceptor
  HY hydrophobic  | NE negative     | CV covalent warhead | CR cation-pi
  XB halogen-bond donor | EX exclusion volume (never set on ligand atoms)

Deviations (documented):
  * NE molecule-level count = number of flagged atoms (the reference counts
    match multiplicity across overlapping SMARTS).
  * Plain dialkyl-ketone O is not MB (the reference's MB list also omits it).
  * AR plane normal uses the first two neighbors instead of a random pair
    (reference process_mols.py:818 uses random.sample - unseeded).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .mol import AROMATIC_BOND, Molecule

PHORETYPES = ["MB", "HD", "AR", "PO", "HA", "HY", "NE", "CV", "CR", "XB", "EX"]
NUM_PHORETYPE = 11
PI = float(np.pi)


def _order(mol: Molecule, i: int, j: int) -> float:
    o = mol.bond_lookup[(i, j)]
    return 1.5 if o == AROMATIC_BOND else float(o)


def _double_nbrs(mol: Molecule, i: int, zs=None) -> List[int]:
    out = []
    for j in mol.neighbors[i]:
        if mol.bond_lookup[(i, j)] == 2 and (zs is None or mol.atoms[j].atomic_num in zs):
            out.append(j)
    return out


def _heavy_nbrs(mol: Molecule, i: int) -> List[int]:
    return [j for j in mol.neighbors[i] if mol.atoms[j].atomic_num != 1]


def _valence(mol: Molecule, i: int) -> int:
    """Integer total valence: heavy-bond orders + all hydrogens."""
    s = sum(_order(mol, i, j) for j in _heavy_nbrs(mol, i))
    return int(np.ceil(s - 1e-9)) + mol.total_h_count(i)


def _is_acid_central(mol: Molecule, i: int) -> bool:
    """C/S/P center with =O/=S and at least one -O(-)/OH sibling."""
    a = mol.atoms[i]
    if a.atomic_num not in (6, 15, 16):
        return False
    has_dbl = bool(_double_nbrs(mol, i, (8, 16)))
    if not has_dbl:
        return False
    for j in _heavy_nbrs(mol, i):
        aj = mol.atoms[j]
        if aj.atomic_num == 8 and mol.bond_lookup[(i, j)] == 1:
            if aj.charge < 0 or mol.total_h_count(j) >= 1:
                return True
    return False


def perceive_phore_types(mol: Molecule) -> Tuple[np.ndarray, Dict[str, int]]:
    """Per-atom pharmacophore fingerprints + molecule-level counts.

    Returns:
      fp: (num_atoms, 11) float array of 0/1 flags (columns = PHORETYPES).
      counts: dict of molecule-level `_<TYPE>` counts.
    """
    n = mol.num_atoms
    fp = np.zeros((n, NUM_PHORETYPE), dtype=np.float64)
    col = {t: k for k, t in enumerate(PHORETYPES)}

    for i, a in enumerate(mol.atoms):
        z = a.atomic_num
        if z == 1:
            continue
        nbrs = _heavy_nbrs(mol, i)
        n_h = mol.total_h_count(i)
        doubles = _double_nbrs(mol, i)

        # ---- HD: N/O/S, charge 0..+2, with >= 1 H
        if z in (7, 8, 16) and 0 <= a.charge <= 2 and n_h >= 1:
            fp[i, col["HD"]] = 1

        # ---- HA (acceptor union) - reference SMARTS process_mols.py:80:
        # [O,S;H1;v2]-[!$(*=[O,N,P,S])] | [O,S;H0;v2] | [O,S;-] |
        # [N;v3;!$(N-*=!@[O,N,P,S])] | [nH0,o,s;+0]
        ha = False
        if z in (8, 16) and not a.is_aromatic:
            if a.charge < 0:
                ha = True
            elif _valence(mol, i) == 2:
                if n_h == 1:
                    # hydroxyl/thiol: exclude when the attached heavy atom
                    # carries a double bond to O/N/P/S (acid OH -> NE)
                    j = nbrs[0] if nbrs else None
                    if j is None or not _double_nbrs(mol, j, (7, 8, 15, 16)):
                        ha = True
                elif n_h == 0:
                    # [O,S;H0;v2]: ethers, thioethers AND carbonyl/sulfonyl/
                    # phosphoryl O (valence 2 via one double bond)
                    ha = True
        if z == 7 and not a.is_aromatic and a.charge == 0 and _valence(mol, i) == 3:
            # amine N; exclude amide-like (neighbor with non-ring double bond
            # to O/N/P/S)
            amide_like = any(
                any(
                    not mol.bond_in_ring(j, k)
                    for k in _double_nbrs(mol, j, (7, 8, 15, 16))
                    if k != i
                )
                for j in nbrs
            )
            if not amide_like:
                ha = True
        if a.is_aromatic and a.charge == 0:
            if (z == 7 and n_h == 0) or z in (8, 16):
                ha = True
        if ha:
            fp[i, col["HA"]] = 1

        # ---- MB (metal binder union)
        mb = False
        if z == 8 and a.charge <= 0:
            if not doubles:
                mb = True  # sp3 O: alcohols, ethers, alkoxides ([O^3])
            else:
                j = doubles[0]
                zj = mol.atoms[j].atomic_num
                if zj in (7, 15, 16):
                    mb = True  # P=O, S=O, N=O oxygens
                elif zj == 6:
                    cn = _heavy_nbrs(mol, j)
                    if (
                        any(mol.atoms[k].atomic_num in (7, 8, 16) for k in cn if k != i)
                        or mol.total_h_count(j) >= 1
                        or any(
                            all(
                                mol.atoms[f].atomic_num == 9
                                for f in _heavy_nbrs(mol, k)
                                if f != j
                            )
                            and len(_heavy_nbrs(mol, k)) == 4
                            for k in cn
                            if k != i and mol.atoms[k].atomic_num == 6
                        )
                    ):
                        mb = True  # acid/ester/amide/thioester/aldehyde/CF3-keto O
        if z == 8 and a.is_aromatic:
            mb = True  # furan-type O
        if z == 16:
            if a.is_aromatic:
                mb = True  # thiophene S
            elif not doubles and len(nbrs) == 2 and n_h == 0:
                mb = True  # sp3 thioether ([S^3D2])
            elif any(
                mol.atoms[j].atomic_num == 6 and mol.bond_lookup[(i, j)] == 2
                for j in nbrs
            ):
                mb = True  # C=S sulfur (thioamide/thiourea)
        if z == 7 and a.charge <= 0:
            if a.is_aromatic:
                if n_h >= 1 or len(nbrs) + n_h <= 2:
                    mb = True  # pyridine-type n / aromatic NH
            else:
                mb = True  # sp2/sp3 amine-like N ([#7^2,#7^3])
        if z == 34 and n_h >= 1:
            mb = True  # Se-H
        if ha:
            mb = True  # the HA pattern is also in the MB table
        if mb:
            fp[i, col["MB"]] = 1

        # ---- PO: positive (not nitro N+), guanidine/amidine carbon
        if a.charge > 0 and not (
            z == 7 and any(mol.atoms[j].charge < 0 and mol.atoms[j].atomic_num == 8 for j in nbrs)
        ):
            fp[i, col["PO"]] = 1
        if z == 6 and not a.is_aromatic:
            n_single_n = [
                j for j in nbrs
                if mol.atoms[j].atomic_num == 7 and mol.bond_lookup[(i, j)] == 1
            ]
            n_double_n = _double_nbrs(mol, i, (7,))
            if len(n_single_n) >= 1 and len(n_double_n) == 1:
                fp[i, col["PO"]] = 1  # N-C(-N)=N

        # ---- NE: acid-group O/S (carboxylate, phosphate, sulfonate)
        for j in nbrs:
            if _is_acid_central(mol, j):
                if mol.bond_lookup[(i, j)] == 2 and z in (8, 16):
                    fp[i, col["NE"]] = 1
                if (
                    mol.bond_lookup[(i, j)] == 1
                    and z == 8
                    and (a.charge < 0 or n_h >= 1)
                ):
                    fp[i, col["NE"]] = 1

        # ---- AR / CR
        if a.is_aromatic:
            fp[i, col["AR"]] = 1

        # ---- XB: halogen sigma-hole donor
        if z in (17, 35, 53) and len(nbrs) == 1 and mol.atoms[nbrs[0]].atomic_num == 6:
            fp[i, col["XB"]] = 1

        # ---- HY: hydrophobic
        hy = False
        if z == 6:
            if a.is_aromatic:
                hy = True
            elif a.charge == 0 and not any(
                mol.atoms[j].atomic_num in (7, 8, 9) for j in nbrs
            ):
                hy = True
        elif z == 16:
            if a.is_aromatic or (n_h == 0 and _valence(mol, i) == 2):
                hy = True
        elif z in (35, 53):
            hy = True
        if hy:
            fp[i, col["HY"]] = 1

        # ---- CV: covalent warheads (major families)
        cv = False
        if z == 6:
            # nitrile carbon
            if any(
                mol.bond_lookup[(i, j)] == 3 and mol.atoms[j].atomic_num == 7
                for j in nbrs
            ):
                cv = True
            # aldehyde carbon
            if n_h >= 1 and _double_nbrs(mol, i, (8,)):
                cv = True
            # 3-ring with O or N (epoxide / aziridine carbons)
            if mol.is_atom_in_ring_of_size(i, 3) and any(
                mol.atoms[j].atomic_num in (7, 8) and mol.bond_in_ring(i, j)
                for j in nbrs
            ):
                cv = True
            # Michael acceptor / vinyl sulfone terminus: C=C conjugated to
            # C=O(N/O) or S(=O)(=O)
            for j in _double_nbrs(mol, i, (6,)):
                for k in _heavy_nbrs(mol, j):
                    if k == i:
                        continue
                    ak = mol.atoms[k]
                    if ak.atomic_num == 6 and _double_nbrs(mol, k, (8,)) and any(
                        mol.atoms[m].atomic_num in (7, 8)
                        for m in _heavy_nbrs(mol, k)
                        if m != j
                    ):
                        cv = True
                    if ak.atomic_num == 16 and len(_double_nbrs(mol, k, (8,))) >= 2:
                        cv = True
            # halo-alkyl carbon: C bonded to halogen, sp3
            if not a.is_aromatic and not doubles and any(
                mol.atoms[j].atomic_num in (9, 17, 35, 53) for j in nbrs
            ):
                cv = True
        elif z == 16:
            if n_h >= 1:
                cv = True  # thiol
            if any(
                mol.atoms[j].atomic_num == 16 for j in nbrs
            ):
                cv = True  # disulfide
            if any(mol.atoms[j].atomic_num == 9 for j in nbrs) and len(
                _double_nbrs(mol, i, (8,))
            ) >= 2:
                cv = True  # sulfonyl fluoride
            if len(_double_nbrs(mol, i, (8,))) == 1 and len(nbrs) == 3 and not a.is_aromatic:
                cv = True  # sulfoxide S
        elif z == 5:
            if sum(1 for j in nbrs if mol.atoms[j].atomic_num == 8 and mol.total_h_count(j) >= 1) >= 2:
                cv = True  # boronic acid
        elif z == 34 and n_h >= 1:
            cv = True
        if cv:
            fp[i, col["CV"]] = 1

    # CR = aromatic or positive-type atoms
    fp[:, col["CR"]] = np.maximum(fp[:, col["AR"]], fp[:, col["PO"]])

    counts = {t: int(fp[:, col[t]].sum()) for t in PHORETYPES}
    # molecule-level overrides matching phore_check (process_mols.py:517-525)
    counts["AR"] = sum(
        1 for ring in mol.sssr if all(mol.atoms[i].is_aromatic for i in ring)
    )
    counts["CR"] = counts["AR"] + counts["PO"]
    counts["EX"] = 0
    return fp, counts


def phore_norms_and_angles(
    mol: Molecule, fp: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-atom, per-type norm vectors + ideal angle windows.

    Mirrors calculate_phore_norms (process_mols.py:782-858): AR uses the ring
    plane normal (cross product of two neighbor vectors); directional types
    use the vector away from the mean neighbor position; MB/HA/HD with one
    root get a pi/3 tolerance window, XB gets 0.
    """
    n = mol.num_atoms
    norms = np.zeros((n, NUM_PHORETYPE, 3))
    angle1 = np.zeros((n, NUM_PHORETYPE))
    angle2 = np.zeros((n, NUM_PHORETYPE))
    coords = mol.coords
    col = {t: k for k, t in enumerate(PHORETYPES)}

    for i in range(n):
        if not fp[i].any():
            continue
        nbrs = _heavy_nbrs(mol, i)
        nb_coords = coords[nbrs] if nbrs else np.zeros((0, 3))
        num_root = len(nbrs)
        root = nb_coords.mean(axis=0) if num_root else coords[i]
        away = coords[i] - root
        away = away / (np.linalg.norm(away) + 1e-12)
        for t_idx in range(NUM_PHORETYPE):
            if fp[i, t_idx] == 0:
                continue
            t = PHORETYPES[t_idx]
            if t == "AR":
                if num_root >= 2:
                    v1 = nb_coords[0] - coords[i]
                    v2 = nb_coords[1] - coords[i]
                    nrm = np.cross(v1, v2)
                    nrm = nrm / (np.linalg.norm(nrm) + 1e-12)
                    norms[i, t_idx] = nrm
                angle1[i, t_idx] = 0.0
                angle2[i, t_idx] = PI
            else:
                norms[i, t_idx] = away
                if t in ("MB", "HA", "HD"):
                    if num_root == 1:
                        angle1[i, t_idx] = PI / 3.0
                        angle2[i, t_idx] = PI / 3.0
                # XB and all others keep 0.0 windows
    return norms, angle1, angle2


def ligand_phore_features(mol: Molecule, follow_ancphore: bool = False):
    """One-stop: (fp, norms, angle1, angle2, counts) for an H-free ligand.

    ``follow_ancphore=True`` replaces the SMARTS-rule HY column with the
    AncPhore lipophilicity-surface perception (chem/lipo.py), mirroring the
    reference's ``hy_check(mol, follow_ancphore=True)`` branch
    (process_mols.py:564-600).  Note the reference pipeline itself never
    enables it — ``analyze_phorefp`` (process_mols.py:437) always calls with
    the default False — so False stays the default here too.
    """
    fp, counts = perceive_phore_types(mol)
    if follow_ancphore:
        from .lipo import hy_check_ancphore

        hy_col = PHORETYPES.index("HY")
        fp = fp.copy()
        fp[:, hy_col] = hy_check_ancphore(mol).astype(fp.dtype)
        counts = dict(counts)
        counts["HY"] = int(fp[:, hy_col].sum())
    norms, a1, a2 = phore_norms_and_angles(mol, fp)
    return fp, norms, a1, a2, counts


def scoring_phore_fp(mol: Molecule) -> np.ndarray:
    """AncPhore-calibrated per-atom fingerprint for FITNESS SCORING.

    Identical to ``perceive_phore_types`` except aromatic nitrogens also
    count as H-bond donors (protonation/tautomer states the closed-source
    AncPhore binary evidently considers).  Calibrated against the 15
    golden complexes of DiffPhore's examples/output/2: flipping
    aromatic-N donors on raises the cross-complex max-fitness rank
    correlation from 0.06 to 0.75 while keeping the within-complex mean
    pose-ranking correlation at 0.81 (measurements in ops/fitscore.py).

    The MODEL featurizer keeps the reference training SMARTS semantics
    (aromatic N without H is not a donor there, process_mols.py:77); this
    variant exists only for the scorer path.
    """
    fp, _ = perceive_phore_types(mol)
    fp = fp.copy()
    hd = PHORETYPES.index("HD")
    for i, a in enumerate(mol.atoms):
        if a.atomic_num == 7 and a.is_aromatic:
            fp[i, hd] = 1.0
    return fp

"""Complex-based pharmacophore generation: protein PDB + bound ligand -> .phore.

The port's copy of ``diffphore_tpu.chem.complex_phore`` (numpy on the
host), with its CLI:

    python -m diffphore_torch.chem.complex_phore protein.pdb ligand.sdf out.phore

Capability replaced: AncPhore's second role - generating a reference
pharmacophore from a protein-ligand complex (reference
process_pharmacophore.py:854 ``generate_complex_phore`` shells out to
``AncPhore -l ligand -p protein --refphore out``; phor_gen command templates
run_phore.py:22-36).  The closed-source binary is absent, so this module
implements the generation host-side from first principles, emitting the same
``.phore`` grammar (data/phore.py) with the standard per-type alpha/weight
tables:

  * ligand features are perceived with the same rules as the featurizer
    (chem/pharmacophore_rules.py): HD/HA/MB/PO/NE/XB/CV per atom, AR per
    aromatic ring (centroid + ring normal), HY per connected hydrophobic
    component (centroid);
  * a feature is EMITTED only when a complementary protein partner exists
    within the interaction cutoff (H-bond 3.9 A, aromatic stack 5.5 A,
    hydrophobic contact 4.5 A, ionic 5.5 A, metal 3.0 A, halogen bond
    4.0 A, covalent Cys-S 3.5 A) - matching the committed example phore,
    whose features sit at ligand positions with norms pointing at the
    protein partners;
  * ``anchor_weight`` counts the distinct protein partners (capped at 3),
    mirroring the anchor emphasis in the committed sQC phore;
  * exclusion volumes are pocket protein heavy atoms within ``ex_cutoff``
    of any ligand heavy atom, alpha 0.837 / weight 0.5 exactly as in the
    committed reference phores.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..constants import PHORE_ALPHA, PHORE_WEIGHT, PHORETYPES
from ..data.phore import Phore, PhoreFeature, write_phore
from .mol import Molecule
from .pharmacophore_rules import perceive_phore_types

# ------------------------------------------------------------ protein model

#: protein H-bond donor atoms by (resname, atom name); '*' = any residue
_PROT_DONORS = {
    ("*", "N"),  # backbone amide
    ("LYS", "NZ"), ("ARG", "NE"), ("ARG", "NH1"), ("ARG", "NH2"),
    ("HIS", "ND1"), ("HIS", "NE2"), ("TRP", "NE1"),
    ("ASN", "ND2"), ("GLN", "NE2"),
    ("SER", "OG"), ("THR", "OG1"), ("TYR", "OH"), ("CYS", "SG"),
}
_PROT_ACCEPTORS = {
    ("*", "O"), ("*", "OXT"),  # backbone carbonyl / terminus
    ("ASP", "OD1"), ("ASP", "OD2"), ("GLU", "OE1"), ("GLU", "OE2"),
    ("ASN", "OD1"), ("GLN", "OE1"),
    ("SER", "OG"), ("THR", "OG1"), ("TYR", "OH"),
    ("HIS", "ND1"), ("HIS", "NE2"), ("MET", "SD"),
}
_PROT_RING_ATOMS = {
    "PHE": ("CG", "CD1", "CD2", "CE1", "CE2", "CZ"),
    "TYR": ("CG", "CD1", "CD2", "CE1", "CE2", "CZ"),
    "TRP": ("CD2", "CE2", "CE3", "CZ2", "CZ3", "CH2"),
    "HIS": ("CG", "ND1", "CD2", "CE1", "NE2"),
}
_PROT_CATION = {("LYS", "NZ"), ("ARG", "CZ"), ("HIS", "CE1")}
_PROT_ANION = {("ASP", "CG"), ("GLU", "CD")}
_HYDROPHOBIC_RES = {"ALA", "VAL", "LEU", "ILE", "PRO", "PHE", "MET", "TRP",
                    "CYS", "TYR"}
_BACKBONE = {"N", "CA", "C", "O", "OXT"}
_METALS = {"ZN", "MG", "MN", "FE", "CA", "NA", "K", "CU", "NI", "CO", "CD",
           "HG"}


@dataclasses.dataclass
class ProteinAtom:
    name: str
    resname: str
    reskey: Tuple[str, str, str]  # (chain, resseq, resname)
    element: str
    coord: np.ndarray
    hetatm: bool


def read_protein_atoms(pdb_path: str) -> List[ProteinAtom]:
    """Lightweight PDB reader keeping residue/atom-name context (the generic
    chem.sdf.parse_pdb drops it, and interaction typing on proteins is far
    more robust from residue templates than from perceived bonds)."""
    atoms: List[ProteinAtom] = []
    with open(pdb_path) as f:
        for ln in f:
            if not ln.startswith(("ATOM", "HETATM")):
                continue
            name = ln[12:16].strip()
            resname = ln[17:20].strip()
            if resname == "HOH":
                continue
            element = (ln[76:78].strip() or name[0]).upper()
            if element == "H" or element == "D":
                continue
            atoms.append(ProteinAtom(
                name=name, resname=resname,
                reskey=(ln[21], ln[22:26].strip(), resname),
                element=element,
                coord=np.array([float(ln[30:38]), float(ln[38:46]),
                                float(ln[46:54])]),
                hetatm=ln.startswith("HETATM"),
            ))
    return atoms


def _match(table, a: ProteinAtom) -> bool:
    return (a.resname, a.name) in table or ("*", a.name) in table


# ----------------------------------------------------- ligand feature sites

def _ligand_sites(mol: Molecule) -> Dict[str, List[Tuple[np.ndarray, List[int]]]]:
    """Per-type candidate sites: (position, member atom indices).

    AR sites are aromatic-ring centroids, HY sites are connected hydrophobic
    component centroids, all other types per atom (as in the featurizer)."""
    fp, _ = perceive_phore_types(mol)
    col = {t: k for k, t in enumerate(PHORETYPES)}
    sites: Dict[str, List[Tuple[np.ndarray, List[int]]]] = {t: [] for t in PHORETYPES}

    for t in ("MB", "HD", "PO", "HA", "NE", "CV", "XB"):
        for i in np.where(fp[:, col[t]] > 0)[0]:
            sites[t].append((mol.coords[i], [int(i)]))

    # AR: aromatic ring centroids
    for ring in mol.sssr:
        if all(mol.atoms[i].is_aromatic for i in ring):
            sites["AR"].append((mol.coords[list(ring)].mean(0), list(ring)))
    sites["CR"] = list(sites["AR"]) + list(sites["PO"])

    # HY: connected components of hydrophobic atoms
    hy = set(int(i) for i in np.where(fp[:, col["HY"]] > 0)[0])
    adj = {i: set() for i in hy}
    for i, j, _ in mol.bonds:
        if i in hy and j in hy:
            adj[i].add(j)
            adj[j].add(i)
    seen = set()
    for i in sorted(hy):
        if i in seen:
            continue
        comp, stack = [], [i]
        while stack:
            x = stack.pop()
            if x in seen:
                continue
            seen.add(x)
            comp.append(x)
            stack.extend(adj[x] - seen)
        sites["HY"].append((mol.coords[comp].mean(0), comp))
    return sites


def _ring_normal(coords: np.ndarray) -> np.ndarray:
    c = coords - coords.mean(0)
    _, _, vt = np.linalg.svd(c, full_matrices=False)
    n = vt[-1]
    return n / max(np.linalg.norm(n), 1e-9)


# ------------------------------------------------------------- the generator

def generate_complex_phore(
    protein_file: str,
    ligand: Molecule,
    out_file: Optional[str] = None,
    name: Optional[str] = None,
    pocket_cutoff: float = 6.0,
    hbond_cutoff: float = 3.9,
    aromatic_cutoff: float = 5.5,
    hydrophobic_cutoff: float = 4.5,
    ionic_cutoff: float = 5.5,
    metal_cutoff: float = 3.0,
    halogen_cutoff: float = 4.0,
    covalent_cutoff: float = 3.5,
    ex_cutoff: float = 4.0,
    overwrite: bool = False,
) -> Phore:
    """Build a reference pharmacophore from a bound complex.

    Returns the Phore; also writes it when ``out_file`` is given (matching
    reference generate_complex_phore's file contract,
    process_pharmacophore.py:854-883)."""
    prot = read_protein_atoms(protein_file)
    if not prot:
        raise ValueError(f"no protein atoms parsed from {protein_file}")
    lig_xyz = ligand.coords
    pxyz = np.stack([a.coord for a in prot])
    # pocket = protein atoms near any ligand atom
    dmin = np.linalg.norm(pxyz[:, None] - lig_xyz[None], axis=-1).min(1)
    pocket_idx = np.where(dmin <= pocket_cutoff)[0]
    pocket = [prot[i] for i in pocket_idx]
    pkt_xyz = pxyz[pocket_idx]

    def partners(site_pos, pred, cutoff):
        d = np.linalg.norm(pkt_xyz - site_pos, axis=-1)
        return [k for k in np.where(d <= cutoff)[0] if pred(pocket[k])]

    # protein aromatic ring centroids in the pocket (by residue)
    rings = {}
    for k, a in enumerate(pocket):
        want = _PROT_RING_ATOMS.get(a.resname)
        if want and a.name in want:
            rings.setdefault(a.reskey, []).append(k)
    ring_centers = [
        pkt_xyz[ks].mean(0) for key, ks in rings.items()
        if len(ks) >= len(_PROT_RING_ATOMS[key[2]]) - 1
    ]

    sites = _ligand_sites(ligand)
    feats: List[PhoreFeature] = []
    ta = {t: PHORE_ALPHA[k] for k, t in enumerate(PHORETYPES)}
    tw = {t: PHORE_WEIGHT[k] for k, t in enumerate(PHORETYPES)}

    def emit(t, pos, partner_positions, norm_from_ring=None):
        if not len(partner_positions):
            return
        pp = np.asarray(partner_positions, float)
        target = pp.mean(0)
        if norm_from_ring is not None:
            n = norm_from_ring
            # orient the ring normal towards the partner side
            if np.dot(target - pos, n) < 0:
                n = -n
            norm_pt = pos + n
        else:
            v = target - pos
            norm_pt = pos + v / max(np.linalg.norm(v), 1e-9)
        feats.append(PhoreFeature(
            type=t, alpha=ta[t], weight=tw[t], factor=1.0,
            coord=(float(pos[0]), float(pos[1]), float(pos[2])),
            has_norm=True,
            norm=(float(norm_pt[0]), float(norm_pt[1]), float(norm_pt[2])),
            label="0", anchor_weight=float(min(len(pp), 3)),
        ))

    is_metal = lambda a: a.hetatm and a.element in _METALS
    is_acc = lambda a: _match(_PROT_ACCEPTORS, a)
    is_don = lambda a: _match(_PROT_DONORS, a)
    is_hyd = lambda a: (a.element == "C" and a.resname in _HYDROPHOBIC_RES
                        and a.name not in _BACKBONE)
    is_cat = lambda a: _match(_PROT_CATION, a)
    is_ani = lambda a: _match(_PROT_ANION, a)
    is_cys_s = lambda a: a.resname == "CYS" and a.name == "SG"
    is_polar = lambda a: a.element in ("N", "O")

    for pos, members in sites["HD"]:
        emit("HD", pos, [pocket[k].coord for k in partners(pos, is_acc, hbond_cutoff)])
    for pos, members in sites["HA"]:
        emit("HA", pos, [pocket[k].coord for k in partners(pos, is_don, hbond_cutoff)])
    for pos, members in sites["MB"]:
        emit("MB", pos, [pocket[k].coord for k in partners(pos, is_metal, metal_cutoff)])
    for pos, members in sites["PO"]:
        emit("PO", pos, [pocket[k].coord for k in partners(pos, is_ani, ionic_cutoff)])
    for pos, members in sites["NE"]:
        emit("NE", pos, [pocket[k].coord for k in partners(pos, is_cat, ionic_cutoff)])
    for pos, members in sites["XB"]:
        emit("XB", pos, [pocket[k].coord for k in partners(pos, is_acc, halogen_cutoff)])
    for pos, members in sites["CV"]:
        emit("CV", pos, [pocket[k].coord for k in partners(pos, is_cys_s, covalent_cutoff)])
    for pos, members in sites["AR"]:
        near_rings = [c for c in ring_centers
                      if np.linalg.norm(c - pos) <= aromatic_cutoff]
        near_cats = [pocket[k].coord for k in partners(pos, is_cat, aromatic_cutoff)]
        if near_rings or near_cats:
            emit("AR", pos, near_rings + near_cats,
                 norm_from_ring=_ring_normal(ligand.coords[members]))
    for pos, members in sites["HY"]:
        emit("HY", pos, [pocket[k].coord for k in partners(pos, is_hyd, hydrophobic_cutoff)])

    # exclusion volumes: pocket heavy atoms close to the ligand envelope
    d_ex = np.linalg.norm(pkt_xyz[:, None] - lig_xyz[None], axis=-1).min(1)
    exs = [
        PhoreFeature(
            type="EX", alpha=0.837, weight=0.5, factor=1.0,
            coord=(float(x[0]), float(x[1]), float(x[2])),
            has_norm=False, norm=(0.0, 0.0, 0.0), label="0", anchor_weight=1.0,
        )
        for x in pkt_xyz[d_ex <= ex_cutoff]
    ]

    phore_id = name or os.path.basename(protein_file).split(".")[0] + "_complex"
    phore = Phore(id=phore_id, features=feats, exclusion_volumes=exs)
    if out_file:
        write_phore(phore, out_file, name=phore_id, overwrite=overwrite)
    return phore


def main(argv: Optional[Sequence[str]] = None) -> None:
    """CLI: python -m diffphore_torch.chem.complex_phore protein.pdb lig.sdf out.phore"""
    import argparse

    from .sdf import read_molecule

    p = argparse.ArgumentParser(description=generate_complex_phore.__doc__)
    p.add_argument("protein")
    p.add_argument("ligand")
    p.add_argument("out")
    p.add_argument("--pocket_cutoff", type=float, default=6.0)
    p.add_argument("--ex_cutoff", type=float, default=4.0)
    p.add_argument("--overwrite", action="store_true")
    args = p.parse_args(argv)
    mol = read_molecule(args.ligand, remove_hs=True)
    if mol is None:
        raise SystemExit(f"could not read ligand {args.ligand}")
    phore = generate_complex_phore(
        args.protein, mol, out_file=args.out,
        pocket_cutoff=args.pocket_cutoff, ex_cutoff=args.ex_cutoff,
        overwrite=args.overwrite,
    )
    print(f"[I] {len(phore.features)} features + "
          f"{len(phore.exclusion_volumes)} exclusion volumes -> {args.out}")


if __name__ == "__main__":
    main()

"""Synthetic drug-like ligand library for ligand-only pretraining.

The port's copy of ``diffphore_tpu.data.synth_library``: the same tables,
the same ``np.random.default_rng(seed)`` stream drawn in the same order, so
one seed gives the same SMILES, string for string.  Candidates are composed
from scaffolds and substituents (v1) or cores, linkers and caps (v2, with a
held-out pool of ring systems), validated through the port's chem kernel
(parse -> 3D embed -> pharmacophore perception) and written as a
``--ligand_only`` training CSV.

Chemistry is biased toward the pharmacophore types the model trains
against (aromatic rings, H-bond donors/acceptors, anions/cations,
hydrophobes) so random sub-phores exercise every feature channel.

Usage:
    python -m diffphore_torch.data.synth_library --n 500 --out lib.csv
    python -m diffphore_torch.cli.train --train_csv lib.csv --ligand_only ...
"""

from __future__ import annotations

import argparse
import csv
from typing import List, Optional, Sequence

import numpy as np

# Scaffolds carry attachment sites: {R*} on carbon, {N*} on nitrogen.
# All strings are plain SMILES once the placeholders are substituted.
# Scaffolds only use ring-closure digits 1/2; substituents use 8/9 so a
# ring substituent can never collide with an open scaffold ring index.
# Kept deliberately small (8-20 heavy atoms before decoration) so the
# decorated molecules stay inside the dataset bucket caps.
SCAFFOLDS: Sequence[str] = (
    "c1ccc({R1})cc1",                      # benzene
    "c1ccc2[nH]c({R1})cc2c1",              # indole
    "c1ccc2nc({R1})[nH]c2c1",              # benzimidazole
    "c1cnc({R1})cn1",                      # pyrazine
    "c1cc({R1})cnc1",                      # pyridine (3-subst)
    "c1csc({R1})n1",                       # thiazole
    "c1cnn({N1})c1",                       # N-subst pyrazole
    "c1nc({R1})no1",                       # oxadiazole
    "C1CCN({N1})CC1",                      # piperidine
    "C1CN({N1})CCN1{N2}",                  # piperazine (two sites)
    "C1COCCN1{N1}",                        # morpholine
    "c1ccc({R1})c({R2})c1",                # ortho-disubst benzene
    "c1cc({R1})cc({R2})c1",                # meta-disubst benzene
    "O=C(c1ccc({R1})cc1)N{N2}",            # benzamide
    "O=C(N{N1})c1cncc({R2})c1",            # nicotinamide
    "O=S(=O)(c1ccc({R1})cc1)N{N2}",        # aryl sulfonamide
    "c1ccc(-c2ccc({R1})cc2)cc1",           # biphenyl
    "c1ccc(C{R1})cc1",                     # benzyl
    "O=C(O)C({R1})N{N2}",                  # amino-acid backbone
    "c1cc2cccnc2c({R1})c1",                # quinoline
)

# Carbon-site substituents; "" is a plain H (site vanishes).  Ring
# fragments use closure digits 8/9 only (see SCAFFOLDS note).
SUBSTITUENTS: Sequence[str] = (
    "",            # H
    "C",           # methyl
    "CC",          # ethyl
    "C(C)C",       # isopropyl
    "O",           # hydroxyl (as -OH via implicit H)
    "OC",          # methoxy
    "N",           # amino
    "NC",          # methylamino
    "N(C)C",       # dimethylamino
    "F", "Cl", "Br",
    "C#N",         # nitrile
    "C(F)(F)F",    # trifluoromethyl
    "C(=O)O",      # carboxylic acid  (anion channel)
    "C(=O)OC",     # ester
    "C(=O)N",      # primary amide
    "C(=O)NC",     # N-methyl amide
    "NC(=O)C",     # acetamido
    "S(=O)(=O)N",  # sulfonamide
    "S(=O)(=O)C",  # methylsulfonyl
    "CN",          # aminomethyl   (cation channel when protonated)
    "CCN",         # aminoethyl
    "C(=O)C",      # acetyl
    "OC(F)F",      # difluoromethoxy
    "c8ccccc8",    # phenyl
    "c8ccncc8",    # pyridyl
    "C8CC8",       # cyclopropyl
    "NC(N)=O",     # urea
)

# Nitrogen-site substituents: only bonds that make chemical sense on an
# amine/amide nitrogen (alkyl, acyl, sulfonyl, aryl); no halogens or
# N-O/N-N single bonds.
N_SUBSTITUENTS: Sequence[str] = (
    "",            # H
    "C",           # N-methyl
    "CC",          # N-ethyl
    "C(C)C",       # N-isopropyl
    "Cc8ccccc8",   # N-benzyl
    "c8ccccc8",    # N-phenyl
    "c8ccncc8",    # N-pyridyl
    "C(=O)C",      # N-acetyl
    "S(=O)(=O)C",  # N-mesyl
    "CC(=O)N",     # amide-terminated ethyl
    "CCO",         # hydroxyethyl
    "C8CC8",       # N-cyclopropyl
)


# --------------------------------------------------------------------------
# v2: flexible chemistry at the scale of DiffPhore's published ligands with
# a SCAFFOLD-LEVEL split.  Molecules are composed as core + linker + cap
# (+ optional second arm + decorations) targeting 20-48 heavy atoms and
# 6-15 rotatable bonds.  The held-out ring systems below NEVER appear in
# pretrain/train/val - test ligands are built from held-out cores AND
# held-out caps only, so the test Murcko scaffolds are disjoint from
# everything trained on.
# --------------------------------------------------------------------------

#: train-side cores (carry {R1}; some a second {R2} site).  The v1
#: SCAFFOLDS above stay train-side too.
CORES_V2_TRAIN = {
    "carbazole": "c1cc({R2})c2c(c1)[nH]c1cc({R1})ccc12",
    "dibenzofuran": "c1cc({R2})c2c(c1)oc1cc({R1})ccc12",
    "benzoxazole": "c1cc({R2})c2oc({R1})nc2c1",
    "indole23": "c1ccc2[nH]c({R1})c({R2})c2c1",
    "pyridopyrazine": "c1cnc2nc({R1})cnc2c1",
    "disubst_pyridine": "c1c({R2})cc({R1})cn1",
    "benzofuran": "c1ccc2oc({R1})c({R2})c2c1",
    "imidazopyridine": "c1ccn2cc({R1})nc2c1",
    "disubst_benzene": "c1cc({R1})ccc1{R2}",
}

#: held-out cores: ring systems absent from every train-side pool
#: (scaffolds, cores, caps, substituents)
CORES_V2_HELDOUT = {
    "naphthalene": "c1c({R1})ccc2cc({R2})ccc12",
    "quinazoline": "c1ccc2c(c1)c({R2})nc({R1})n2",
    "benzothiophene": "c1ccc2sc({R1})c({R2})c2c1",
    "chromone": "O=c1cc({R1})oc2cc({R2})ccc12",
    "indazole": "c1cc({R2})c2c(c1)c({R1})n[nH]2",
    "thn": "C1Cc2ccc({R1})c({R2})c2CC1",   # tetrahydronaphthalene
}

#: terminal ring caps, substituent-form (ring digits 8/9)
CAPS_TRAIN = {
    "phenyl": "c8ccccc8",
    "pyridyl": "c8ccncc8",
    "furyl": "c8ccoc8",
    "pyrimidinyl": "c8ncccn8",
    "cyclohexyl": "C8CCCCC8",
    "fluorophenyl": "c8ccc(F)cc8",
    "methoxyphenyl": "c8ccc(OC)cc8",
    "thiazolyl": "c8nccs8",
}
#: NOTE: quinolinyl is deliberately NOT here - quinoline is a v1 train-side
#: scaffold, so it would leak the ring system across the split
CAPS_HELDOUT = {
    "naphthyl": "c8ccc9ccccc9c8",
    "benzodioxolyl": "c8ccc9OCOc9c8",
    "benzothienyl": "c8cc9ccccc9s8",
    "indanyl": "C8Cc9ccccc9C8",
    "chlorothienyl": "c8ccc(Cl)s8",
}

#: flexible linkers, substituent-form linear chains; the cap fragment is
#: appended directly (the final atom carries the open valence).  Each
#: contributes 2-6 rotatable bonds once bonded to core and cap.
LINKERS = (
    "CC",                 # ethylene
    "CCC",                # propylene
    "OCC",                # ether
    "OCCC",
    "OCCOC",              # glycol ether (terminal CH2 bonds the cap)
    "CNC(=O)",            # reverse amide -> aroyl cap
    "CC(=O)N",            # amide -> anilide cap
    "CCNC(=O)C",          # extended amide
    "NC(=O)CC",
    "OCC(=O)N",           # ester-amide hybrid chain
    "CN(C)CC",            # tertiary-amine chain (cation channel)
    "CSCC",               # thioether
    "COC(=O)",            # ester -> aroyl ester cap
    "CCOCC",              # bis-ether chain
    "NS(=O)(=O)",         # sulfonamide -> aryl sulfonyl cap
    "CNC(=O)CC",
    # longer chains reach the upper end of the published ligands' sizes
    "CCNC(=O)CCC",
    "OCCN(C)CC",
    "CCOCCOC",
    "CNC(=O)CCNC(=O)",
    "OCCCNC(=O)",
)


def _compose_v2(rng: np.random.Generator, cores: dict, caps: dict,
                p_second_arm: float = 0.55):
    """One core + linker + cap molecule (optionally a second arm on {R2}
    and an extra decoration), returning (smiles, meta)."""
    core_name = str(rng.choice(sorted(cores)))
    core = cores[core_name]
    cap_name = str(rng.choice(sorted(caps)))
    arm = str(rng.choice(LINKERS)) + caps[cap_name]
    out = _fill_site(core, "{R1}", arm)
    cap2_name = None
    if "{R2}" in out:
        if rng.random() < p_second_arm:
            cap2_name = str(rng.choice(sorted(caps)))
            arm2 = str(rng.choice(LINKERS)) + caps[cap2_name]
            out = _fill_site(out, "{R2}", arm2)
        else:
            out = _fill_site(out, "{R2}", str(rng.choice(SUBSTITUENTS)))
    for site in ("{N1}", "{N2}"):
        if site in out:
            out = _fill_site(out, site, str(rng.choice(N_SUBSTITUENTS)))
    meta = {"core": core_name, "caps": [cap_name] +
            ([cap2_name] if cap2_name else [])}
    return out, meta


def _topo_stats(smiles: str):
    """(heavy_atoms, n_rotatable, n_feature_atoms) without 3D embedding -
    candidate filtering is topology-only so generation stays fast; the rare
    embed failure is dropped later by the dataset's skip-and-log path."""
    from ..chem.pharmacophore_rules import ligand_phore_features
    from ..chem.smiles import mol_from_smiles
    from ..chem.topology import rotatable_bonds

    mol = mol_from_smiles(smiles)
    edges, _ = rotatable_bonds(mol)
    fp, _, _, _, _ = ligand_phore_features(mol)
    n_feat = int((fp[:, :-1].sum(axis=1) > 0).sum())
    return mol.num_atoms, len(edges), n_feat


def generate_library_v2(
    n: int,
    seed: int = 0,
    heldout: bool = False,
    min_atoms: int = 20,
    max_atoms: int = 48,
    min_torsions: int = 6,
    max_torsions: int = 15,
    min_features: int = 5,
    max_tries: Optional[int] = None,
):
    """Generate ``n`` distinct flexible drug-size SMILES from the
    train-side (default) or held-out scaffold pools.  Returns
    (smiles_list, meta_list); meta records the ring systems used so the
    scaffold split is auditable."""
    rng = np.random.default_rng(seed)
    cores = dict(CORES_V2_HELDOUT if heldout else CORES_V2_TRAIN)
    caps = dict(CAPS_HELDOUT if heldout else CAPS_TRAIN)
    out, metas, seen = [], [], set()
    tries, budget = 0, max_tries if max_tries is not None else max(30 * n, 300)
    while len(out) < n and tries < budget:
        tries += 1
        try:
            smiles, meta = _compose_v2(rng, cores, caps)
            if smiles in seen:
                continue
            seen.add(smiles)
            heavy, tors, feats = _topo_stats(smiles)
        except Exception:  # noqa: BLE001 - generator: invalid candidates are fine
            continue
        if not (min_atoms <= heavy <= max_atoms):
            continue
        if not (min_torsions <= tors <= max_torsions):
            continue
        if feats < min_features:
            continue
        meta.update({"heavy": heavy, "torsions": tors})
        out.append(smiles)
        metas.append(meta)
    return out, metas


def _fill_site(out: str, site: str, sub: str) -> str:
    if sub == "":
        # drop the site; remove an enclosing "()" when the site was the
        # whole group
        return out.replace("(" + site + ")", "").replace(site, "")
    return out.replace("(" + site + ")", "(" + sub + ")").replace(site, sub)


def _substitute(scaffold: str, rng: np.random.Generator) -> str:
    """Fill every {R*} (carbon) / {N*} (nitrogen) site with a random
    substituent from the matching pool."""
    out = scaffold
    for site in ("{R1}", "{R2}"):
        if site in out:
            out = _fill_site(out, site, str(rng.choice(SUBSTITUENTS)))
    for site in ("{N1}", "{N2}"):
        if site in out:
            out = _fill_site(out, site, str(rng.choice(N_SUBSTITUENTS)))
    return out


def _validate(smiles: str, seed: int, min_atoms: int, max_atoms: int,
              min_features: int) -> bool:
    """A candidate is kept when it parses, embeds to 3D, fits the bucket
    caps, and perceives enough pharmacophore features to support random
    sub-phore extraction (phore_sampling.extract_random_phore)."""
    from ..chem.embed import embed_molecule
    from ..chem.pharmacophore_rules import ligand_phore_features
    from ..chem.smiles import mol_from_smiles

    try:
        mol = mol_from_smiles(smiles)
        if not (min_atoms <= mol.num_atoms <= max_atoms):
            return False
        embed_molecule(mol, seed=seed)
        if not np.isfinite(mol.coords).all():
            return False
        fp, _, _, _, _ = ligand_phore_features(mol)
        return int((fp[:, :-1].sum(axis=1) > 0).sum()) >= min_features
    except Exception:  # noqa: BLE001 - generator: invalid candidates are fine
        return False


def generate_library(
    n: int,
    seed: int = 0,
    min_atoms: int = 8,
    max_atoms: int = 48,
    min_features: int = 4,
    max_tries: Optional[int] = None,
) -> List[str]:
    """Generate ``n`` distinct validated drug-like SMILES."""
    rng = np.random.default_rng(seed)
    out: List[str] = []
    seen = set()
    tries = 0
    budget = max_tries if max_tries is not None else max(20 * n, 200)
    while len(out) < n and tries < budget:
        tries += 1
        scaffold = str(rng.choice(SCAFFOLDS))
        smiles = _substitute(scaffold, rng)
        if smiles in seen:
            continue
        seen.add(smiles)
        if _validate(smiles, seed=seed + tries, min_atoms=min_atoms,
                     max_atoms=max_atoms, min_features=min_features):
            out.append(smiles)
    return out


def write_library_csv(path: str, smiles: Sequence[str],
                      name_prefix: str = "synth") -> None:
    """Write a --ligand_only training CSV: ligand_description = SMILES, no
    phore column (featurize_record then derives a random ligand phore)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["name", "ligand_description"])
        for i, s in enumerate(smiles):
            w.writerow([f"{name_prefix}_{i:05d}", s])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n", type=int, default=500)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--min_atoms", type=int, default=8)
    p.add_argument("--max_atoms", type=int, default=48)
    p.add_argument("--min_features", type=int, default=4)
    args = p.parse_args(argv)
    lib = generate_library(args.n, args.seed, args.min_atoms,
                           args.max_atoms, args.min_features)
    write_library_csv(args.out, lib)
    print(f"[I] wrote {len(lib)} ligands -> {args.out}")


if __name__ == "__main__":
    main()

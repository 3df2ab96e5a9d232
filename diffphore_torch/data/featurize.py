"""Featurization of a ligand and a phore into the arrays of a padded complex,
in numpy alone.

A featurization process of the screening CLI imports this module and what it
needs (the host chemistry, the phore parser), never torch: a worker starts in
the time numpy takes to import, not torch's seconds.  The main process turns
the arrays into tensors (``data.graphs.build_complex``,
``ops.fitscore.make_phore_arrays``, ``cli.pipeline.prepare_job``), so a job is
the same whether it was featurized there or in a worker.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Tuple

import numpy as np

from ..chem.embed import embed_molecule
from ..chem.features import bond_features, featurize_atoms
from ..chem.mol import Molecule
from ..chem.pharmacophore_rules import ligand_phore_features, scoring_phore_fp
from ..chem.sdf import read_molecule
from ..chem.smiles import mol_from_smiles
from ..chem.topology import rotatable_bonds
from ..constants import NUM_PHORETYPE, PHORETYPES
from ..utils.logging import log_warn
from .phore import Phore, PhoreGraph, build_phore_graph, parse_phore, type_index


def round_up(x: int, step: int, minimum: Optional[int] = None) -> int:
    """x rounded up to a multiple of ``step``, at least ``minimum`` (default
    ``step``)."""
    return max(step if minimum is None else minimum, ((x + step - 1) // step) * step)


def complex_arrays(
    name: str,
    mol: Molecule,
    phore: Phore,
    a_pad: Optional[int] = None,
    p_pad: Optional[int] = None,
    t_pad: Optional[int] = None,
    consider_ex: bool = True,
    neighbor_cutoff: Optional[float] = 5.0,
    ex_connected: bool = True,
    move_to_center: bool = True,
    orig_pos: Optional[np.ndarray] = None,
    meta: Optional[Dict] = None,
) -> Tuple[Dict[str, np.ndarray], Dict]:
    """The fields (B = 1, numpy) and the metadata of one (H-free ligand,
    phore) pair: the ligand graph, the phore graph, the rule-based
    pharmacophore fingerprints and norms, both centered on the phore's
    centroid.  Pads default to multiples of 8 atoms, 8 points and 4
    torsion slots."""
    if any(a.atomic_num == 1 for a in mol.atoms):
        raise ValueError(f"{name}: the ligand must be H-free")
    n_atoms = mol.num_atoms
    pg: PhoreGraph = build_phore_graph(phore, consider_ex, neighbor_cutoff, ex_connected)
    n_phore = pg.pos.shape[0]
    edges, masks = rotatable_bonds(mol)
    n_tor = len(edges)

    A = round_up(n_atoms, 8) if a_pad is None else a_pad
    P = round_up(n_phore, 8) if p_pad is None else p_pad
    T = round_up(max(n_tor, 1), 4) if t_pad is None else t_pad
    if n_atoms > A or n_phore > P or n_tor > T:
        raise ValueError(
            f"{name}: sizes (A={n_atoms}, P={n_phore}, T={n_tor}) exceed pads ({A},{P},{T})")

    fp, norms, ang1, ang2, counts = ligand_phore_features(mol)
    arrays: Dict[str, np.ndarray] = {}

    def padded(shape, dtype, value, rows=n_atoms):
        out = np.zeros(shape, dtype)
        out[:rows] = value
        return out

    arrays["lig_feat"] = padded((A, 16), np.int32, featurize_atoms(mol))
    arrays["lig_pos"] = padded((A, 3), np.float32, mol.coords)
    arrays["lig_mask"] = padded(A, bool, True)
    arrays["lig_phorefp"] = padded((A, NUM_PHORETYPE), np.float32, fp)
    arrays["lig_scorer_fp"] = padded((A, NUM_PHORETYPE), np.float32, scoring_phore_fp(mol))
    lig_norm = np.zeros((NUM_PHORETYPE, A, 3), np.float32)
    lig_norm[:, :n_atoms] = np.transpose(norms, (1, 0, 2))
    arrays["lig_norm"] = lig_norm
    arrays["lig_norm_angle1"] = padded((A, NUM_PHORETYPE), np.float32, ang1)
    arrays["lig_norm_angle2"] = padded((A, NUM_PHORETYPE), np.float32, ang2)
    arrays["lig_ph"] = np.asarray([counts[t] for t in PHORETYPES], np.float32)

    bond_attr = np.zeros((A, A, 4), np.float32)
    bond_mask = np.zeros((A, A), bool)
    for i, j, o in mol.bonds:
        bf = bond_features(o)
        bond_attr[i, j] = bf
        bond_attr[j, i] = bf
        bond_mask[i, j] = bond_mask[j, i] = True
    arrays["bond_attr"], arrays["bond_mask"] = bond_attr, bond_mask

    mask_rot = np.zeros((T, A), bool)
    if n_tor:
        mask_rot[:n_tor, :n_atoms] = masks
    arrays["tor_edges"] = padded((T, 2), np.int32, edges, n_tor)
    arrays["tor_mask"] = padded(T, bool, True, n_tor)
    arrays["mask_rotate"] = mask_rot

    arrays["phore_x"] = padded((P, 5), np.float32, pg.x, n_phore)
    arrays["phore_pos"] = padded((P, 3), np.float32, pg.pos, n_phore)
    arrays["phore_norm"] = padded((P, 3), np.float32, pg.norm, n_phore)
    arrays["phore_mask"] = padded(P, bool, True, n_phore)
    arrays["phoretype"] = padded((P, NUM_PHORETYPE), np.float32, pg.phoretype, n_phore)
    pem = np.zeros((P, P), bool)
    pem[pg.edge_index[0], pg.edge_index[1]] = True
    arrays["phore_edge_mask"] = pem

    center = pg.pos.mean(axis=0).astype(np.float32)
    if move_to_center:
        arrays["lig_pos"][:n_atoms] -= center
        arrays["phore_pos"][:n_phore] -= center
    arrays["orig_center"] = center

    md = dict(meta or {})
    md.setdefault("n_atoms", n_atoms)
    md.setdefault("n_phore", n_phore)
    md.setdefault("n_tor", n_tor)
    if orig_pos is not None:
        md["orig_pos"] = np.asarray(orig_pos)
    arrays = {k: v[None] for k, v in arrays.items()}
    arrays["t"] = np.zeros(1, np.float32)
    arrays["valid"] = np.ones(1, bool)
    return arrays, md


def phore_arrays(phore: Phore, pad: Optional[int] = None) -> Dict[str, np.ndarray]:
    """A phore file's points as one row (B = 1), in the file's frame, padded
    to ``pad`` points: the fields of ``ops.fitscore.PhoreArrays``, with the
    file's last column as the anchor weight."""
    pts = phore.all_points
    P = pad or len(pts)
    out = {"coord": np.zeros((1, P, 3), np.float32),
           "type_onehot": np.zeros((1, P, NUM_PHORETYPE), np.float32),
           "alpha": np.ones((1, P), np.float32), "weight": np.zeros((1, P), np.float32),
           "anchor": np.zeros((1, P), np.float32), "is_ex": np.zeros((1, P), bool),
           "mask": np.zeros((1, P), bool)}
    for k, p in enumerate(pts):
        out["coord"][0, k] = p.coord
        out["type_onehot"][0, k, type_index(p.type)] = 1.0
        out["alpha"][0, k] = p.alpha
        out["weight"][0, k] = p.weight
        out["anchor"][0, k] = p.anchor_weight
        out["is_ex"][0, k] = p.type == "EX"
        out["mask"][0, k] = True
    return out


def load_ligand(description: str, keep_local_structures: bool = True) -> Optional[Molecule]:
    """An SDF/MOL/MOL2/PDB path or a SMILES string -> an H-free 3D molecule
    (SMILES are embedded; files too without ``keep_local_structures``), or
    None when it cannot be read."""
    if os.path.exists(description):
        mol = read_molecule(description, remove_hs=True)
        if mol is not None and not keep_local_structures:
            embed_molecule(mol)
        return mol
    try:
        mol = mol_from_smiles(description)
    except Exception as e:  # noqa: BLE001 - report and skip the ligand
        log_warn(f"Failed to parse ligand description `{description}`: {e}")
        return None
    embed_molecule(mol)
    return mol


def featurize(name: str, ligand_description: str, phore_path: str,
              keep_local_structures: bool = True) -> Optional[Dict]:
    """One (ligand, first phore of the file) pair as the arrays of a screening
    job: the complex padded to buckets of 8 atoms (at least 16), 16 phore
    points and 4 torsion slots, the phore file's points (phore-centered) and
    the molecule; None when the ligand or the phore cannot be read."""
    mol = load_ligand(ligand_description, keep_local_structures)
    if mol is None or mol.num_atoms < 2:
        return None
    phores = parse_phore(phore_path)
    if not phores:
        log_warn(f"No pharmacophore parsed from `{phore_path}`")
        return None
    phore = phores[0]
    p_pad = round_up(len(phore.all_points), 16)
    arrays, md = complex_arrays(name, mol, phore, a_pad=round_up(mol.num_atoms, 8, 16),
                                p_pad=p_pad, meta={"phore_file": phore_path})
    ref = phore_arrays(phore, pad=p_pad)
    ref["coord"] = ref["coord"] - arrays["orig_center"][0]
    return {"name": name, "batch": arrays, "meta": md, "ref": ref, "mol": mol}


def featurize_timed(name: str, ligand_description: str, phore_path: str,
                    keep_local_structures: bool) -> Tuple[Optional[Dict], float, Optional[str]]:
    """:func:`featurize` in a worker process: (its arrays or None, seconds,
    the repr of what it raised or None)."""
    t0 = time.time()
    try:
        job = featurize(name, ligand_description, phore_path, keep_local_structures)
    except Exception as e:  # noqa: BLE001 - the main process logs it and skips the record
        return None, time.time() - t0, repr(e)
    return job, time.time() - t0, None

"""Padded ligand-pharmacophore complexes as tensors.

Field for field the same batch as ``diffphore_tpu.data.graphs.ComplexBatch``:
a complex is padded to bucket sizes (A atoms, P phore points, T torsion
slots) and its graphs are dense masked grids.  Every field has a leading
batch axis B.  ``build_complex`` featurizes an H-free ligand and a phore on
the host (CPU tensors, moved to the device by the caller); ``load_cached``
reads the featurized ``.npz`` caches that the JAX package writes
(``data/cache/*/*.npz``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..chem.features import bond_features, featurize_atoms
from ..chem.mol import Molecule
from ..chem.pharmacophore_rules import ligand_phore_features, scoring_phore_fp
from ..chem.topology import rotatable_bonds
from ..constants import NUM_PHORETYPE, PHORETYPES
from .phore import Phore, PhoreGraph, build_phore_graph


@dataclasses.dataclass
class ComplexBatch:
    # ligand
    lig_feat: torch.Tensor         # (B, A, 16) int64 categorical features
    lig_pos: torch.Tensor          # (B, A, 3) f32, phore-centered frame
    lig_mask: torch.Tensor         # (B, A) bool
    lig_phorefp: torch.Tensor      # (B, A, 11) f32
    lig_norm: torch.Tensor         # (B, 11, A, 3) f32 relative norm vectors
    lig_norm_angle1: torch.Tensor  # (B, A, 11) f32
    lig_norm_angle2: torch.Tensor  # (B, A, 11) f32
    lig_ph: torch.Tensor           # (B, 11) f32 molecule-level type counts
    bond_attr: torch.Tensor        # (B, A, A, 4) f32 one-hot bond features
    bond_mask: torch.Tensor        # (B, A, A) bool
    # torsions
    tor_edges: torch.Tensor        # (B, T, 2) int64
    tor_mask: torch.Tensor         # (B, T) bool
    mask_rotate: torch.Tensor      # (B, T, A) bool
    # pharmacophore
    phore_x: torch.Tensor          # (B, P, 5) f32 [type, is_ex, has_norm, alpha, weight]
    phore_pos: torch.Tensor        # (B, P, 3) f32
    phore_norm: torch.Tensor       # (B, P, 3) f32
    phore_mask: torch.Tensor       # (B, P) bool
    phoretype: torch.Tensor        # (B, P, 11) f32 one-hot
    phore_edge_mask: torch.Tensor  # (B, P, P) bool
    # bookkeeping
    orig_center: torch.Tensor      # (B, 3) f32 phore centroid in the input frame
    t: torch.Tensor                # (B,) f32 diffusion time
    valid: torch.Tensor            # (B,) bool
    lig_scorer_fp: torch.Tensor    # (B, A, 11) f32 fingerprint the fitness scorer reads
    # host-only metadata
    names: Sequence[str] = ()
    meta: Sequence[Dict] = ()

    @property
    def batch_size(self) -> int:
        return self.lig_pos.shape[0]

    @property
    def num_atoms(self) -> int:
        return self.lig_pos.shape[1]

    @property
    def num_phore(self) -> int:
        return self.phore_pos.shape[1]

    @property
    def num_torsions(self) -> int:
        return self.tor_edges.shape[1]

    @property
    def device(self) -> torch.device:
        return self.lig_pos.device

    def replace(self, **changes: Any) -> "ComplexBatch":
        return dataclasses.replace(self, **changes)

    def tensors(self) -> Dict[str, torch.Tensor]:
        return {name: getattr(self, name) for name in ARRAY_FIELDS}

    def to(self, device) -> "ComplexBatch":
        return self.replace(**{k: v.to(device) for k, v in self.tensors().items()})


ARRAY_FIELDS = tuple(
    f.name for f in dataclasses.fields(ComplexBatch) if f.name not in ("names", "meta"))


def _as_tensor(x: np.ndarray) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype.kind in "iu":
        return torch.from_numpy(x.astype(np.int64))
    if x.dtype == np.bool_:
        return torch.from_numpy(x.copy())
    return torch.from_numpy(x.astype(np.float32))


def from_numpy(arrays: Dict[str, np.ndarray], names: Sequence[str] = (),
               meta: Sequence[Dict] = ()) -> ComplexBatch:
    """Build a batch from numpy arrays keyed by field name."""
    arrays = dict(arrays)
    b = np.asarray(arrays["lig_pos"]).shape[0]
    arrays.setdefault("valid", np.ones(b, bool))
    arrays.setdefault("lig_scorer_fp", arrays["lig_phorefp"])
    return ComplexBatch(names=tuple(names), meta=tuple(meta),
                        **{k: _as_tensor(arrays[k]) for k in ARRAY_FIELDS})


def load_cached(path: str, device: Optional[torch.device] = None) -> ComplexBatch:
    """One featurized complex (B = 1) from a cache ``.npz``."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta"].tobytes()).decode())
        name = meta.pop("name")
        if "__orig_pos" in z.files:
            meta["orig_pos"] = z["__orig_pos"]
        arrays = {k: z[k] for k in ARRAY_FIELDS if k in z.files}
    batch = from_numpy(arrays, names=(name,), meta=(meta,))
    return batch if device is None else batch.to(device)


def concat_batches(batches: Sequence[ComplexBatch]) -> ComplexBatch:
    """Stack same-shape complexes along the batch axis."""
    first = batches[0]
    return first.replace(
        names=tuple(n for b in batches for n in b.names),
        meta=tuple(m for b in batches for m in b.meta),
        **{k: torch.cat([getattr(b, k) for b in batches], 0) for k in ARRAY_FIELDS})


def repeat_batch(batch: ComplexBatch, n: int) -> ComplexBatch:
    """Tile a B = 1 complex into n identical poses."""
    return batch.replace(
        names=tuple(batch.names) * n, meta=tuple(batch.meta) * n,
        **{k: torch.repeat_interleave(v, n, dim=0) for k, v in batch.tensors().items()})


def round_up(x: int, step: int, minimum: Optional[int] = None) -> int:
    """x rounded up to a multiple of ``step``, at least ``minimum`` (default
    ``step``)."""
    return max(step if minimum is None else minimum, ((x + step - 1) // step) * step)


def build_complex(
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
) -> ComplexBatch:
    """Featurize one (H-free ligand, phore) pair into a B = 1 padded batch
    of CPU tensors: the ligand graph, the phore graph, the rule-based
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
    return from_numpy(arrays, names=(name,), meta=(md,))


#: the padded axes of each field, after the batch axis: "A" atoms, "P" phore
#: points, "T" torsion slots, None an axis that keeps its size
PAD_AXES: Dict[str, tuple] = {
    "lig_feat": ("A", None), "lig_pos": ("A", None), "lig_mask": ("A",),
    "lig_phorefp": ("A", None), "lig_norm": (None, "A", None),
    "lig_norm_angle1": ("A", None), "lig_norm_angle2": ("A", None), "lig_ph": (None,),
    "bond_attr": ("A", "A", None), "bond_mask": ("A", "A"),
    "tor_edges": ("T", None), "tor_mask": ("T",), "mask_rotate": ("T", "A"),
    "phore_x": ("P", None), "phore_pos": ("P", None), "phore_norm": ("P", None),
    "phore_mask": ("P",), "phoretype": ("P", None), "phore_edge_mask": ("P", "P"),
    "orig_center": (None,), "t": (), "valid": (), "lig_scorer_fp": ("A", None),
}


def pad_to_bucket(batches: Sequence[ComplexBatch], a_pad: int, p_pad: int,
                  t_pad: int) -> List[ComplexBatch]:
    """Re-pad complexes with zeros to common bucket sizes so that they can
    be concatenated."""
    sizes = {"A": a_pad, "P": p_pad, "T": t_pad}
    out = []
    for bb in batches:
        fields = {}
        for name, v in bb.tensors().items():
            shape = (v.shape[0],) + tuple(
                n if axis is None else sizes[axis] for axis, n in zip(PAD_AXES[name], v.shape[1:]))
            new = v.new_zeros(shape)
            new[tuple(slice(0, n) for n in v.shape)] = v
            fields[name] = new
        out.append(bb.replace(**fields))
    return out

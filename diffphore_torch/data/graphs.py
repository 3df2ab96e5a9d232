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

from ..chem.mol import Molecule
from .featurize import complex_arrays
from .phore import Phore


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


def build_complex(name: str, mol: Molecule, phore: Phore, **kw) -> ComplexBatch:
    """Featurize one (H-free ligand, phore) pair into a B = 1 padded batch
    of CPU tensors: :func:`data.featurize.complex_arrays` (its keywords: the
    pads, the phore graph's settings, ``orig_pos``, ``meta``) as tensors."""
    arrays, md = complex_arrays(name, mol, phore, **kw)
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

"""Conformer modification: apply (translation, rotation, torsions) to poses.

Rigid move about the ligand centroid, sequential torsion rotations, then a
Kabsch re-alignment of the flexible pose onto the rigid one so that torsion
updates do not leak rigid-body motion.  Batched over poses.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .geometry import axis_angle_to_matrix, kabsch
from .torsion import apply_torsion_updates


def _rot(x: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """x @ R.T per pose; x (B, ..., 3), R (B, 3, 3)."""
    return torch.einsum("b...i,bji->b...j", x, R)


def modify_conformer(
    pos: torch.Tensor,
    norm: torch.Tensor,
    atom_mask: torch.Tensor,
    tor_edges: torch.Tensor,
    mask_rotate: torch.Tensor,
    tor_mask: torch.Tensor,
    tr_update: torch.Tensor,
    rot_update: torch.Tensor,
    torsion_updates: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply one diffusion update to padded poses.

    Args:
      pos: (B, A, 3); norm: (B, K, A, 3) relative norm vectors.
      atom_mask: (B, A); tor_edges: (B, T, 2); mask_rotate: (B, T, A);
      tor_mask: (B, T); tr_update, rot_update: (B, 3) (rotation as axis-angle);
      torsion_updates: (B, T).
    Returns:
      (pos', norm').
    """
    w = atom_mask.to(pos.dtype)[..., None]
    center = torch.sum(pos * w, dim=1) / torch.clamp(torch.sum(w, dim=1), min=1.0)

    R = axis_angle_to_matrix(rot_update)
    rigid_pos = _rot(pos - center[:, None], R) + tr_update[:, None] + center[:, None]
    abs_norm = norm + pos[:, None]  # to absolute endpoints
    abs_norm = (_rot(abs_norm - center[:, None, None], R) + tr_update[:, None, None]
                + center[:, None, None])

    flex_pos, flex_norm = apply_torsion_updates(
        rigid_pos, tor_edges, mask_rotate, torsion_updates, tor_mask, aux_points=abs_norm)
    Rk, tk = kabsch(flex_pos, rigid_pos, mask=atom_mask)
    aligned_pos = _rot(flex_pos, Rk) + tk[:, None]
    aligned_norm = _rot(flex_norm, Rk) + tk[:, None, None]
    return aligned_pos, aligned_norm - aligned_pos[:, None]

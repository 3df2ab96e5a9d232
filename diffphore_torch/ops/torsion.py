"""Torsion-angle updates, batched over poses.

Bond order matters (rotating bond k can move the pivot atoms of bond k+1),
so the bonds are applied in a sequential loop over the padded bond axis.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .geometry import axis_angle_to_matrix


def apply_torsion_updates(
    pos: torch.Tensor,
    tor_edges: torch.Tensor,
    mask_rotate: torch.Tensor,
    torsion_updates: torch.Tensor,
    tor_mask: torch.Tensor,
    aux_points: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Sequentially rotate atom subsets around rotatable bonds.

    Args:
      pos: (B, A, 3) atom positions.
      tor_edges: (B, T, 2) bond endpoints (u, v); the side containing v
        rotates.
      mask_rotate: (B, T, A) bool atoms moved by each bond.
      torsion_updates: (B, T) angles (radians); tor_mask: (B, T) validity.
      aux_points: optional (B, K, A, 3) per-atom points rotated with the
        same masks (absolute pharmacophore-norm endpoints).
    """
    updates = torch.where(tor_mask, torsion_updates, torch.zeros_like(torsion_updates))
    rows = torch.arange(pos.shape[0], device=pos.device)
    for k in range(tor_edges.shape[1]):
        u, v = tor_edges[:, k, 0], tor_edges[:, k, 1]
        pivot = pos[rows, v]                                    # (B, 3)
        rot_vec = pos[rows, u] - pivot
        rot_vec = (rot_vec / torch.clamp(torch.linalg.norm(rot_vec, dim=-1, keepdim=True),
                                         min=1e-12) * updates[:, k, None])
        R = axis_angle_to_matrix(rot_vec)                       # (B, 3, 3)
        m = mask_rotate[:, k, :, None]                          # (B, A, 1)
        moved = torch.einsum("bai,bji->baj", pos - pivot[:, None], R) + pivot[:, None]
        pos = torch.where(m, moved, pos)
        if aux_points is not None:
            moved = (torch.einsum("bkai,bji->bkaj", aux_points - pivot[:, None, None], R)
                     + pivot[:, None, None])
            aux_points = torch.where(m[:, None], moved, aux_points)
    return pos, aux_points

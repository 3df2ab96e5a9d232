"""Coordinate recovery from predicted distance maps (the tank mode's pose
generation): ligand coordinates by Adam on a weighted MSE between predicted
ligand-phore cross distances and LAS-constrained intra-ligand distances,
from several random initializations run as one batch."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8   # optax.adam's defaults


def _safe_norm(x: torch.Tensor) -> torch.Tensor:
    # the square root at exactly 0 has no gradient; the intra matrix's
    # diagonal hits it
    return torch.sqrt((x * x).sum(-1) + 1e-12)


def distance_loss(
    coords: torch.Tensor,       # (..., A, 3)
    phore_pos: torch.Tensor,    # (P, 3)
    pred_dist: torch.Tensor,    # (A, P) predicted cross distances
    cross_mask: torch.Tensor,   # (A, P) bool
    holo_dist: torch.Tensor,    # (A, A) target intra distances (LAS)
    intra_mask: torch.Tensor,   # (A, A) bool
    cross_weight: float = 1.0,
    intra_weight: float = 1.0,
    cross_cutoff: float = 10.0,
) -> torch.Tensor:
    """Weighted MSE of cross and intra distances, one value per leading
    index of ``coords``; predicted cross distances at or beyond the cutoff
    are left out."""
    d_cross = _safe_norm(coords[..., :, None, :] - phore_pos[None, :, :])
    m_cross = (cross_mask & (pred_dist < cross_cutoff)).to(coords.dtype)
    cross = (((d_cross - pred_dist) ** 2) * m_cross).sum((-2, -1)) / torch.clamp(
        m_cross.sum(), min=1.0)
    d_intra = _safe_norm(coords[..., :, None, :] - coords[..., None, :, :])
    m_intra = intra_mask.to(coords.dtype)
    intra = (((d_intra - holo_dist) ** 2) * m_intra).sum((-2, -1)) / torch.clamp(
        m_intra.sum(), min=1.0)
    return cross_weight * cross + intra_weight * intra


def recover_coords(
    phore_pos: torch.Tensor,
    pred_dist: torch.Tensor,
    cross_mask: torch.Tensor,
    holo_dist: torch.Tensor,
    intra_mask: torch.Tensor,
    n_init: int = 4,
    steps: int = 500,
    lr: float = 0.1,
    init_spread: float = 4.0,
    init: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run Adam (optax.adam: b1 0.9, b2 0.999, eps 1e-8 outside the square
    root) for ``steps`` steps from ``n_init`` initializations at once and
    return (coords (A, 3), loss) of the run with the lowest final loss.
    ``init`` (n_init, A, 3) gives the initial coordinates; by default they
    are the mean of ``phore_pos`` (padding rows included, as in the JAX
    package) plus ``init_spread`` standard normals from ``generator``."""
    A = holo_dist.shape[0]
    if init is None:
        z = torch.randn((n_init, A, 3), generator=generator, device=phore_pos.device)
        init = phore_pos.mean(0) + init_spread * z
    x = init.detach().clone()
    mu, nu = torch.zeros_like(x), torch.zeros_like(x)
    b1, b2 = torch.tensor(ADAM_B1), torch.tensor(ADAM_B2)          # f32, as optax's
    args = (phore_pos, pred_dist, cross_mask, holo_dist, intra_mask)
    for t in range(1, steps + 1):
        with torch.enable_grad():
            x.requires_grad_(True)
            (g,) = torch.autograd.grad(distance_loss(x, *args).sum(), x)
        x = x.detach()
        with torch.no_grad():
            mu.mul_(ADAM_B1).add_(g, alpha=1.0 - ADAM_B1)
            nu.mul_(ADAM_B2).addcmul_(g, g, value=1.0 - ADAM_B2)
            mu_hat = mu / float(1 - b1 ** t)
            nu_hat = nu / float(1 - b2 ** t)
            x = x - lr * (mu_hat / (torch.sqrt(nu_hat) + ADAM_EPS))
    with torch.no_grad():
        final = distance_loss(x, *args)
    best = int(torch.argmin(final))
    return x[best], final[best]


def las_distance_matrix(mol, coords: Optional[np.ndarray] = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Local-atomic-structure targets of a ``chem.mol.Molecule``: pairs
    within two bonds or on a shared ring keep their conformer distance,
    other pairs are unconstrained.  Returns (holo_dist (A, A) f32, mask
    (A, A) bool)."""
    A = mol.num_atoms
    adj = np.zeros((A, A), bool)
    for i, j, _ in mol.bonds:
        adj[i, j] = adj[j, i] = True
    two_hop = adj @ adj | adj
    ring_pair = np.zeros((A, A), bool)
    for ring in mol.sssr:
        for i in ring:
            for j in ring:
                ring_pair[i, j] = True
    mask = (two_hop | ring_pair) & ~np.eye(A, dtype=bool)
    c = mol.coords if coords is None else coords
    d = np.linalg.norm(c[:, None] - c[None, :], axis=-1)
    return d.astype(np.float32), mask

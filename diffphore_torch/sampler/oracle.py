"""Analytic (oracle) score functions that certify the reverse-diffusion
chain.

The training targets are closed-form functions of the applied noise
(``tr_score = -tr / sigma^2``, the IGSO(3) score at the drawn rotation, the
wrapped-normal score at the drawn torsions), so a perfectly trained model
predicts them as measured from the pose it is shown.  This module measures
them against a clean pose: the centroid offset (exact: the pose update
moves the masked centroid by the translation), the rotation by masked
Kabsch between the centered poses (exact when the torsions agree, second
order in their offsets otherwise), and per-bond dihedral differences
(exact: dihedrals are invariant under the rigid move and the Kabsch
re-alignment).  :func:`make_oracle_score_fn` is a drop-in ``score_fn`` for
``sampler.sampling.reverse_diffusion``: a chain fed the oracle must recover
the pose, whatever the weights of any model.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ..ops import so3, torus
from ..ops.diffusion import SigmaSchedule
from ..ops.geometry import kabsch, matrix_to_axis_angle


def dihedral_reference_atoms(bond_mask: np.ndarray, tor_edges: np.ndarray,
                             tor_mask: np.ndarray, mask_rotate: np.ndarray) -> np.ndarray:
    """Fixed-side and rotating-side reference atoms per rotatable bond (u,
    v) of one graph: (T, 2) int ``(a, b)``, ``a`` a neighbor of u outside the
    rotating mask and ``b`` a neighbor of v inside it, for the dihedral
    a-u-v-b.  Padded slots get (0, 0)."""
    T = tor_edges.shape[0]
    out = np.zeros((T, 2), np.int64)
    bm, mr = np.asarray(bond_mask), np.asarray(mask_rotate)
    for k in range(T):
        if not tor_mask[k]:
            continue
        u, v = int(tor_edges[k, 0]), int(tor_edges[k, 1])
        a_cands = [a for a in np.where(bm[u])[0] if a != v and not mr[k, a]]
        b_cands = [b for b in np.where(bm[v])[0] if b != u and mr[k, b]]
        if not a_cands or not b_cands:
            raise ValueError(f"torsion bond {k} ({u},{v}) has no dihedral refs")
        out[k] = (a_cands[0], b_cands[0])
    return out


def measure_dihedrals(pos: torch.Tensor, tor_edges: torch.Tensor,
                      ref_atoms: torch.Tensor) -> torch.Tensor:
    """Dihedral a-u-v-b per torsion slot, (B, A, 3) -> (B, T).  A torsion
    update of +theta (``ops.torsion.apply_torsion_updates``) raises it by
    +theta."""
    rows = torch.arange(pos.shape[0], device=pos.device)[:, None]
    a = pos[rows, ref_atoms[..., 0]]
    u = pos[rows, tor_edges[..., 0]]
    v = pos[rows, tor_edges[..., 1]]
    b = pos[rows, ref_atoms[..., 1]]
    b0 = a - u
    b1 = v - u
    b1 = b1 / torch.clamp(torch.linalg.norm(b1, dim=-1, keepdim=True), min=1e-12)
    b2 = b - v
    v_perp = b0 - (b0 * b1).sum(-1, keepdim=True) * b1
    w_perp = b2 - (b2 * b1).sum(-1, keepdim=True) * b1
    x = (v_perp * w_perp).sum(-1)
    y = (torch.linalg.cross(b1, v_perp, dim=-1) * w_perp).sum(-1)
    # the torsion update rotates the b side about u - v = -b1: a positive
    # update lowers atan2(y, x)
    return -torch.atan2(y, x)


def pose_offsets(batch, true_pos: torch.Tensor, true_dih: torch.Tensor,
                 ref_atoms: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(tr_offset (B, 3), rot_vec (B, 3), tor_delta (B, T)) of the batch's
    current pose relative to ``true_pos``."""
    m = batch.lig_mask.to(batch.lig_pos.dtype)
    wsum = torch.clamp(m.sum(-1, keepdim=True), min=1.0)
    c_cur = (batch.lig_pos * m[..., None]).sum(-2) / wsum
    c_true = (true_pos * m[..., None]).sum(-2) / wsum
    R, _ = kabsch(true_pos, batch.lig_pos, mask=batch.lig_mask)   # cur ~ true @ R.T + t
    cur_dih = measure_dihedrals(batch.lig_pos, batch.tor_edges, ref_atoms)
    tor_delta = torus.wrap(cur_dih - true_dih) * batch.tor_mask
    return c_cur - c_true, matrix_to_axis_angle(R), tor_delta


def make_oracle_score_fn(clean_batch, schedule: SigmaSchedule) -> Callable:
    """A ``score_fn`` for ``reverse_diffusion`` that returns the analytic
    scores of the current pose's offsets from ``clean_batch`` at the
    diffusion time ``batch.t`` the sampler sets."""
    true_pos = clean_batch.lig_pos.clone()
    ref_atoms = torch.from_numpy(np.stack([
        dihedral_reference_atoms(clean_batch.bond_mask[i].cpu().numpy(),
                                 clean_batch.tor_edges[i].cpu().numpy(),
                                 clean_batch.tor_mask[i].cpu().numpy(),
                                 clean_batch.mask_rotate[i].cpu().numpy())
        for i in range(clean_batch.batch_size)])).to(true_pos.device)
    true_dih = measure_dihedrals(true_pos, clean_batch.tor_edges, ref_atoms)

    def score_fn(b):
        tr_sigma, rot_sigma, tor_sigma = schedule(b.t)
        tr_off, rot_vec, tor_delta = pose_offsets(b, true_pos, true_dih, ref_atoms)
        tr_score = -tr_off / tr_sigma[:, None] ** 2
        rot_score = so3.score_vec(rot_sigma, rot_vec)
        tor_score = torus.score(tor_delta, tor_sigma[:, None]) * b.tor_mask
        return tr_score, rot_score, tor_score

    return score_fn

"""Sigma-weighted denoising score-matching loss: translation MSE scaled by
sigma_tr^2, rotation MSE normalized by the IGSO3 score-norm table, torsion
MSE normalized by the torus score-norm table, padded torsion slots masked."""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from ..ops import so3, torus
from ..ops.diffusion import SigmaSchedule


class ScoreTargets(NamedTuple):
    """Ground-truth scores produced by the noise transform."""

    tr_score: torch.Tensor   # (B, 3)
    rot_score: torch.Tensor  # (B, 3)
    tor_score: torch.Tensor  # (B, T)
    tor_sigma: torch.Tensor  # (B,) per-graph torsion sigma


def score_matching_loss(
    preds,
    targets: ScoreTargets,
    t: torch.Tensor,
    tor_mask: torch.Tensor,
    schedule: SigmaSchedule,
    tr_weight: float = 0.33,
    rot_weight: float = 0.33,
    tor_weight: float = 0.33,
    no_torsion: bool = False,
    apply_mean: bool = True,
    valid: Optional[torch.Tensor] = None,
    shard=None,
) -> Dict[str, torch.Tensor]:
    """``apply_mean=False`` returns per-graph (B,) losses instead of scalars
    (the validation epoch buckets them by sigma interval).  ``valid`` is a
    (B,) weight mask: repeat-padded rows of a short final batch contribute
    zero to every reduction.  With a ``shard`` (``parallel.mesh.DataShard``)
    the inputs are this rank's rows and each scalar is this rank's share of
    the global batch's value: the weights are summed over the ranks, and the
    shares sum to the value."""
    tr_pred, rot_pred, tor_pred = preds
    tr_sigma, rot_sigma, _ = schedule(t)
    w = torch.ones_like(t, dtype=tr_pred.dtype) if valid is None else valid.to(tr_pred.dtype)
    total = (lambda v: v) if shard is None else shard.sum
    if apply_mean:
        w_sum = torch.clamp(total(w.sum()), min=1.0)

        def red(x):  # per-graph mean over the trailing axis, then validity-weighted mean
            return (x.mean(-1) * w).sum() / w_sum
    else:
        def red(x):
            return x.mean(-1)

    tr_loss = red((tr_pred - targets.tr_score) ** 2 * tr_sigma[:, None] ** 2)
    tr_base = red((targets.tr_score ** 2) * tr_sigma[:, None] ** 2)

    rot_norm = so3.score_norm(rot_sigma)[:, None]
    rot_loss = red(((rot_pred - targets.rot_score) / rot_norm) ** 2)
    rot_base = red((targets.rot_score / rot_norm) ** 2)

    if no_torsion:
        tor_loss = tor_base = torch.zeros(() if apply_mean else t.shape, dtype=tr_pred.dtype,
                                          device=t.device)
    else:
        tor_norm2 = torus.score_norm(targets.tor_sigma)[:, None]  # (B, 1)
        m = tor_mask.to(tr_pred.dtype)
        if apply_mean:
            # element-weighted over all real torsion slots; invalid graphs zeroed
            m = m * w[:, None]
            denom = torch.clamp(total(m.sum()), min=1.0)
            tor_loss = (((tor_pred - targets.tor_score) ** 2 / tor_norm2) * m).sum() / denom
            tor_base = (((targets.tor_score ** 2) / tor_norm2) * m).sum() / denom
        else:
            denom = torch.clamp(m.sum(-1), min=1.0)
            tor_loss = (((tor_pred - targets.tor_score) ** 2 / tor_norm2) * m).sum(-1) / denom
            tor_base = (((targets.tor_score ** 2) / tor_norm2) * m).sum(-1) / denom

    loss = tr_loss * tr_weight + rot_loss * rot_weight + tor_loss * tor_weight
    return {
        "loss": loss,
        "tr_loss": tr_loss, "rot_loss": rot_loss, "tor_loss": tor_loss,
        "tr_base_loss": tr_base, "rot_base_loss": rot_base, "tor_base_loss": tor_base,
    }

"""Training of the confidence head on noised poses.

Each batch is noised inside the step as for the score model (a random t per
graph), and the labels are computed from the noised pose in the same step by
the analytic fitness score (``ops.fitscore``): the calibrated PhScore1 and
the pharmacophore and exclusion overlap shares.  With ``label_mode =
"rmsd_lt2"`` the first label is whether the noised pose lies within 2 A of
the clean one, and the first output its logit.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..constants import VDW_TABLE
from ..data.transforms import NoiseDraws, apply_noise
from ..models.confidence import ConfidenceModel
from ..models.layers import batch_statistics
from ..models.score_model import ScoreModelConfig, init_parameters, set_dropout_generator
from ..ops.fitscore import batch_phore_arrays, fitscore
from .state import TrainState, apply_gradients, create_train_state

LABEL_MODES = ("fitness", "rmsd_lt2")


def confidence_labels(batch, vdw_table=VDW_TABLE
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(phscore1, ov_pct, ex_pct), each (B,), of the batch's current poses."""
    vdw = torch.as_tensor(vdw_table, device=batch.device)[batch.lig_feat[..., 0]]
    s = fitscore(batch.lig_pos, batch.lig_mask, batch.lig_scorer_fp, vdw,
                 batch_phore_arrays(batch))
    return s["phscore1"], s["ov_pct"], s["ex_pct"]


def confidence_loss(preds, labels, by_total: bool = False,
                    label_mode: str = "fitness") -> Dict[str, torch.Tensor]:
    """``fitness``: the MSE of the ph and ex pair, or of the first output
    alone with ``by_total``.  ``rmsd_lt2``: a sigmoid cross entropy of the
    first output (a logit) against the 0/1 label, plus 0.1 x the ph and ex
    MSEs.  Returns loss, loss_ph, loss_ex and loss_total."""
    fit_p, ph_p, ex_p = preds
    fit_l, ph_l, ex_l = labels
    loss_ph = ((ph_p - ph_l) ** 2).mean()
    loss_ex = ((ex_p - ex_l) ** 2).mean()
    if label_mode == "rmsd_lt2":
        # the numerically stable form of the binary cross entropy of a logit
        loss_total = (torch.clamp(fit_p, min=0.0) - fit_p * fit_l
                      + torch.log1p(torch.exp(-fit_p.abs()))).mean()
        loss = loss_total + 0.1 * (loss_ph + loss_ex)
    else:
        loss_total = ((fit_p - fit_l) ** 2).mean()
        loss = loss_total if by_total else loss_ph + loss_ex
    return {"loss": loss, "loss_ph": loss_ph, "loss_ex": loss_ex, "loss_total": loss_total}


def pose_rmsd_to_clean(noised_pos: torch.Tensor, clean_pos: torch.Tensor,
                       lig_mask: torch.Tensor) -> torch.Tensor:
    """Per-graph RMSD between the noised and the clean pose, in the same
    frame and without realignment: the pose's error."""
    d2 = ((noised_pos - clean_pos) ** 2).sum(-1)
    m = lig_mask.to(d2.dtype)
    return torch.sqrt((d2 * m).sum(-1) / torch.clamp(m.sum(-1), min=1.0))


def create_confidence_train_state(cfg: ScoreModelConfig, confidence_dropout: float = 0.0,
                                  seed: int = 0, lr: float = 1e-3, weight_decay: float = 0.0,
                                  device: Optional[str] = None) -> TrainState:
    """A fresh head (weights from ``seed``) with its optimizer and EMA, on
    ``device`` (the GPU unless the caller asks for the CPU)."""
    model = init_parameters(ConfidenceModel(cfg, confidence_dropout), seed)
    return create_train_state(cfg, lr=lr, weight_decay=weight_decay, device=device, model=model)


def _noised_and_labels(batch, cfg: ScoreModelConfig, generator, draws, label_mode: str):
    if label_mode not in LABEL_MODES:
        raise ValueError(f"label_mode {label_mode!r}: one of {LABEL_MODES}")
    noised, _ = apply_noise(batch, cfg.sigma_schedule, generator, draws,
                            no_torsion=cfg.no_torsion)
    labels = confidence_labels(noised)
    if label_mode == "rmsd_lt2":
        rmsd = pose_rmsd_to_clean(noised.lig_pos, batch.lig_pos, batch.lig_mask)
        labels = ((rmsd < 2.0).to(torch.float32),) + tuple(labels[1:])
    return noised, labels


def make_confidence_train_step(cfg: ScoreModelConfig, ema_decay: float = 0.999,
                               by_total: bool = False, label_mode: str = "fitness") -> Callable:
    """Build ``step(state, batch, generator=None, draws=None) -> (state,
    metrics)``: noise the clean batch, label the noised poses, run the head
    in training mode (dropout from ``generator``, batch statistics), then
    the NaN guard, the optimizer update and the EMA blend.  ``draws``
    replays given noise."""

    def step(state: TrainState, batch, generator: Optional[torch.Generator] = None,
             draws: Optional[NoiseDraws] = None):
        with torch.no_grad():
            noised, labels = _noised_and_labels(batch, cfg, generator, draws, label_mode)
        model = state.model
        model.train()
        set_dropout_generator(model, generator)
        state.optimizer.zero_grad(set_to_none=True)
        metrics = confidence_loss(model(noised), labels, by_total, label_mode)
        ok = apply_gradients(state, metrics["loss"], ema_decay)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_finite"] = ok.to(torch.float32)
        return state, metrics

    return step


def make_confidence_eval_step(cfg: ScoreModelConfig, by_total: bool = False,
                              label_mode: str = "fitness") -> Callable:
    """Build ``step(model, batch, generator=None, draws=None) -> metrics`` on
    freshly noised poses: no dropout and the convolutions' eval route, but
    each batch norm normalizes by the batch's own statistics and its running
    statistics stay as they were."""

    @torch.no_grad()
    def step(model: ConfidenceModel, batch, generator: Optional[torch.Generator] = None,
             draws: Optional[NoiseDraws] = None):
        noised, labels = _noised_and_labels(batch, cfg, generator, draws, label_mode)
        model.eval()
        with batch_statistics(model):
            preds = model(noised)
        return confidence_loss(preds, labels, by_total, label_mode)

    return step

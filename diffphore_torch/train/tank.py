"""Training of the tank mode (``cli.train --model_type tank``): the
TANKBind-style model regresses the ligand-phore cross distance map (MSE
against the true map clamped at ``dis_cutoff``, or BCE with logits against
the contact map with ``pred_dis`` off) plus an optional per-graph affinity.
The train step has the score model's conventions: NaN guard, the JAX
optimizer's settings, EMA.  Poses come from the predicted maps through
:mod:`diffphore_torch.ops.coord_recovery`.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as Fn

from ..device import resolve_device
from ..models.score_model import init_parameters, set_dropout_generator
from ..models.trioformer import TankPhore
from ..ops.coord_recovery import las_distance_matrix, recover_coords
from .state import TrainState, apply_gradients, make_optimizer


def dis_map_targets(batch, dis_cutoff: float = 10.0
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dis_map, contact_y, pair_mask), each (B, A, P) f32, of the clean
    batch: cross distances clamped at ``dis_cutoff``, contacts below it, and
    the valid pairs.  Assumes the ligand pose and the phore share a frame,
    as every training complex does."""
    d = torch.linalg.norm(batch.lig_pos[:, :, None, :] - batch.phore_pos[:, None, :, :], dim=-1)
    pair_mask = batch.lig_mask[:, :, None] & batch.phore_mask[:, None, :]
    return (torch.clamp(d, max=dis_cutoff), (d < dis_cutoff).to(torch.float32),
            pair_mask.to(torch.float32))


def tank_loss(
    y_pred: torch.Tensor,         # (B, A, P) distances or contact logits
    affinity_pred: torch.Tensor,  # (B,)
    dis_map: torch.Tensor,
    contact_y: torch.Tensor,
    pair_mask: torch.Tensor,
    affinity: torch.Tensor,       # (B,)
    consider_affinity: bool = True,
    pred_dis: bool = True,
    contact_weight: float = 1.0,
    affinity_weight: float = 0.01,
    pose_weight: float = 5.0,
) -> Dict[str, torch.Tensor]:
    """The masked tank loss: the contact term (MSE of distances, or BCE with
    logits whose positive class weighs ``pose_weight``) times
    ``contact_weight``, plus the affinity MSE times ``affinity_weight``."""
    n = torch.clamp(pair_mask.sum(), min=1.0)
    if pred_dis:
        contact_loss = (((y_pred - dis_map) ** 2) * pair_mask).sum() / n
    else:
        bce = -(pose_weight * contact_y * Fn.logsigmoid(y_pred)
                + (1.0 - contact_y) * Fn.logsigmoid(-y_pred))
        contact_loss = (bce * pair_mask).sum() / n
    contact_loss = contact_loss * contact_weight
    if consider_affinity:
        affinity_loss = ((affinity_pred - affinity) ** 2).mean() * affinity_weight
    else:
        affinity_loss = torch.zeros((), device=y_pred.device)
    return {"loss": contact_loss + affinity_loss, "contact_loss": contact_loss,
            "affinity_loss": affinity_loss}


def create_tank_train_state(hidden_dim: int = 16, n_blocks: int = 8, seed: int = 0,
                            lr: float = 1e-3, weight_decay: float = 0.0,
                            device: Optional[str] = None,
                            model: Optional[TankPhore] = None) -> TrainState:
    """A fresh state on ``device`` (the GPU unless the caller asks for the
    CPU): weights drawn from ``seed``, or those of ``model``."""
    dev = resolve_device(device)
    if model is None:
        model = init_parameters(TankPhore(hidden_dim, n_blocks), seed)
    model = model.to(dev)
    ema = {name: p.detach().clone() for name, p in model.named_parameters()}
    return TrainState(model=model, optimizer=make_optimizer(model.parameters(), lr, weight_decay),
                      ema_params=ema)


def make_tank_train_step(ema_decay: float = 0.999, consider_affinity: bool = True,
                         pred_dis: bool = True, contact_weight: float = 1.0,
                         affinity_weight: float = 0.01, pose_weight: float = 5.0,
                         dis_cutoff: float = 10.0) -> Callable:
    """``step(state, batch, affinity, generator=None) -> (state, metrics)``:
    the targets, the training-mode forward (dropout from ``generator``), the
    loss, then the score model's update (a non-finite loss zeroes the
    gradients), Adam and the EMA blend."""

    def step(state: TrainState, batch, affinity: torch.Tensor,
             generator: Optional[torch.Generator] = None):
        model = state.model
        model.train()
        set_dropout_generator(model, generator)
        state.optimizer.zero_grad(set_to_none=True)
        with torch.no_grad():
            dis_map, contact_y, pair_mask = dis_map_targets(batch, dis_cutoff)
        y_pred, aff_pred = model(batch)
        loss = tank_loss(y_pred, aff_pred, dis_map, contact_y, pair_mask, affinity,
                         consider_affinity, pred_dis, contact_weight, affinity_weight,
                         pose_weight)["loss"]
        ok = apply_gradients(state, loss, ema_decay)
        return state, {"loss": loss.detach(), "grad_finite": ok.to(torch.float32)}

    return step


def make_tank_eval_step(consider_affinity: bool = True, pred_dis: bool = True,
                        contact_weight: float = 1.0, affinity_weight: float = 0.01,
                        pose_weight: float = 5.0, dis_cutoff: float = 10.0) -> Callable:
    """``step(model, batch, affinity) -> metrics``: the eval-mode forward and
    the loss terms."""

    @torch.no_grad()
    def step(model: TankPhore, batch, affinity: torch.Tensor):
        dis_map, contact_y, pair_mask = dis_map_targets(batch, dis_cutoff)
        model.eval()
        y_pred, aff_pred = model(batch)
        return tank_loss(y_pred, aff_pred, dis_map, contact_y, pair_mask, affinity,
                         consider_affinity, pred_dis, contact_weight, affinity_weight,
                         pose_weight)

    return step


@torch.no_grad()
def tank_pose_metrics(model: TankPhore, batch, mols: Sequence, n_init: int = 4,
                      steps: int = 500, inits: Optional[Sequence[torch.Tensor]] = None,
                      generator: Optional[torch.Generator] = None) -> dict:
    """Pose generation and the RMSD gate of the tank model: predict the
    cross distance map, recover coordinates against each molecule's LAS
    distances, and report the RMSDs to ``batch.lig_pos`` (the true pose of
    the clean batch) with the shares under 2 and 5 A.  ``mols`` are the
    ``chem.mol.Molecule`` of the batch rows; ``inits`` (one (n_init, A, 3)
    tensor per row) replace the random initializations."""
    model.eval()
    y_pred, _ = model(batch)
    y_pred = y_pred.abs()
    A = batch.lig_pos.shape[1]
    dev = batch.lig_pos.device
    rmsds = []
    for g, mol in enumerate(mols):
        holo, intra = las_distance_matrix(mol)
        n = holo.shape[0]
        holo_t = torch.zeros((A, A), device=dev)
        intra_t = torch.zeros((A, A), dtype=torch.bool, device=dev)
        holo_t[:n, :n] = torch.from_numpy(holo)
        intra_t[:n, :n] = torch.from_numpy(intra)
        cross_mask = batch.lig_mask[g][:, None] & batch.phore_mask[g][None, :]
        coords, _ = recover_coords(batch.phore_pos[g], y_pred[g], cross_mask, holo_t, intra_t,
                                   n_init=n_init, steps=steps,
                                   init=None if inits is None else inits[g],
                                   generator=generator)
        m = batch.lig_mask[g]
        diff = (coords[m] - batch.lig_pos[g][m]).double().cpu().numpy()
        rmsds.append(float(np.sqrt((diff ** 2).sum(-1).mean())))
    r = np.asarray(rmsds)
    return {"rmsds": r.tolist(), "rmsds_lt2": float(100.0 * (r < 2.0).mean()),
            "rmsds_lt5": float(100.0 * (r < 5.0).mean())}

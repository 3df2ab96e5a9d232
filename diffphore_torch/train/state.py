"""Train state and the train / validation steps.

The state owns the model (parameters and batch-norm running statistics),
the Adam or AdamW optimizer, the EMA shadow of the parameters (decay 0.999
by default) and the step count.  The steps run eagerly on the state's
device and update it in place; the plateau controller of the training loop
writes the learning rate through :func:`set_learning_rate`.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, Optional

import torch

from ..data.transforms import NoiseDraws, apply_noise, draw_noise
from ..device import resolve_device
from ..models.layers import Dropout, data_parallel
from ..models.score_model import (ScoreModel, ScoreModelConfig, init_parameters,
                                  set_dropout_generator)
from ..parallel.mesh import shard_rows
from .losses import score_matching_loss


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module               # a ScoreModel or a ConfidenceModel
    optimizer: torch.optim.Optimizer
    ema_params: Dict[str, torch.Tensor]   # by parameter name
    step: int = 0

    @property
    def learning_rate(self) -> float:
        return float(self.optimizer.param_groups[0]["lr"])

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def make_optimizer(params, lr: float = 1e-3, weight_decay: float = 0.0) -> torch.optim.Optimizer:
    if weight_decay > 0:
        return torch.optim.AdamW(params, lr=lr, weight_decay=weight_decay)
    return torch.optim.Adam(params, lr=lr)


def create_train_state(cfg: ScoreModelConfig, seed: int = 0, lr: float = 1e-3,
                       weight_decay: float = 0.0, device: Optional[str] = None,
                       model: Optional[ScoreModel] = None) -> TrainState:
    """A fresh state on ``device`` (the GPU unless the caller asks for the
    CPU): weights drawn from ``seed``, or those of ``model`` when given."""
    dev = resolve_device(device)
    if model is None:
        model = init_parameters(ScoreModel(cfg), seed)
    model = model.to(dev)
    ema = {name: p.detach().clone() for name, p in model.named_parameters()}
    return TrainState(model=model, optimizer=make_optimizer(model.parameters(), lr, weight_decay),
                      ema_params=ema)


def ema_model(state: TrainState) -> torch.nn.Module:
    """An eval-mode copy of the state's model holding the EMA shadow as its
    parameters (and the current batch statistics); its dropouts hold no
    generator."""
    generators = {id(m.generator): None for m in state.model.modules()
                  if isinstance(m, Dropout) and m.generator is not None}
    model = copy.deepcopy(state.model, memo=generators)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(state.ema_params[name])
    return model.eval()


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    for group in state.optimizer.param_groups:
        group["lr"] = float(lr)
    return state


def apply_gradients(state: TrainState, loss: torch.Tensor, ema_decay: float,
                    shard=None) -> torch.Tensor:
    """The backward of ``loss``, the NaN guard (a non-finite loss zeroes the
    gradients and keeps the step count aligned), the optimizer update and
    the EMA blend; returns whether the loss was finite (a 0-d tensor).  With
    a ``shard`` (``parallel.mesh.DataShard``) ``loss`` is this rank's share
    of the global loss: the gradients are summed over the ranks and the guard
    reads the global loss, so every rank takes or skips the same update and
    the replicas stay identical."""
    model = state.model
    loss.backward()
    with torch.no_grad():
        if shard is None:
            ok = torch.isfinite(loss)
            for p in model.parameters():
                p.grad = (torch.zeros_like(p) if p.grad is None
                          else torch.nan_to_num(p.grad) * ok)
        else:
            ok = torch.isfinite(shard.sum(loss.detach()))
            params = list(model.parameters())
            grads = shard.sum_gradients([torch.zeros_like(p) if p.grad is None else p.grad
                                         for p in params])
            for p, g in zip(params, grads):
                p.grad = torch.nan_to_num(g) * ok
        state.optimizer.step()
        for name, p in model.named_parameters():
            state.ema_params[name].mul_(ema_decay).add_(p, alpha=1.0 - ema_decay)
    state.step += 1
    return ok


def optimize(state: TrainState, cfg: ScoreModelConfig, noised, targets, batch,
             generator: Optional[torch.Generator], ema_decay: float, tr_weight: float,
             rot_weight: float, tor_weight: float, shard=None):
    """The part of a train step after the noise: the forward in training mode
    (dropout from ``generator``, batch statistics), the loss, then
    :func:`apply_gradients`.  Returns (state, metrics); ``metrics`` are 0-d
    tensors on the device, ``grad_finite`` among them.  With a ``shard`` the
    batch is this rank's rows and the metrics are the global batch's."""
    model = state.model
    model.train()
    set_dropout_generator(model, generator)
    state.optimizer.zero_grad(set_to_none=True)
    with data_parallel(model, shard):
        preds = model(noised)
    metrics = score_matching_loss(
        preds, targets, noised.t, batch.tor_mask, cfg.sigma_schedule,
        tr_weight, rot_weight, tor_weight, cfg.no_torsion, valid=batch.valid, shard=shard)
    ok = apply_gradients(state, metrics["loss"], ema_decay, shard)
    metrics = {k: v.detach() for k, v in metrics.items()}
    if shard is not None:
        metrics = dict(zip(metrics, shard.sum(torch.stack(list(metrics.values()))).unbind()))
    metrics["grad_finite"] = ok.to(torch.float32)
    return state, metrics


def make_train_step(
    cfg: ScoreModelConfig,
    ema_decay: float = 0.999,
    tr_weight: float = 0.33,
    rot_weight: float = 0.33,
    tor_weight: float = 0.33,
    reject: bool = False,
    shard=None,
) -> Callable:
    """Build ``step(state, batch, generator=None, reject_prob=0.0, draws=None)
    -> (state, metrics)``: noise the clean batch, then :func:`optimize`.
    ``generator`` feeds the noise and the dropout masks; ``draws`` replays
    given noise.  Built with a ``shard`` (``parallel.mesh.DataShard``), the
    step takes the global batch and its draws, keeps this rank's rows of
    both, and returns the global metrics: the data-parallel step of
    ``diffphore_tpu.parallel.mesh.shard_train_step``."""
    schedule = cfg.sigma_schedule

    def step(state: TrainState, batch, generator: Optional[torch.Generator] = None,
             reject_prob: float = 0.0, draws: Optional[NoiseDraws] = None):
        reject_prob = reject_prob if reject else 0.0
        with torch.no_grad():
            if shard is not None:
                B = batch.batch_size
                if draws is None:
                    draws = draw_noise(B, batch.num_torsions, generator, batch.device,
                                       reject_prob > 0)
                batch, draws = shard_rows(batch, shard.rank, shard.world), draws.rows(
                    shard.rows(B))
            noised, targets = apply_noise(batch, schedule, generator, draws,
                                          no_torsion=cfg.no_torsion, reject_prob=reject_prob)
        return optimize(state, cfg, noised, targets, batch, generator, ema_decay, tr_weight,
                        rot_weight, tor_weight, shard)

    return step


def make_eval_step(
    cfg: ScoreModelConfig,
    tr_weight: float = 0.33,
    rot_weight: float = 0.33,
    tor_weight: float = 0.33,
    shard=None,
) -> Callable:
    """Build the validation-loss step ``step(model, batch, generator=None,
    draws=None) -> metrics``: noise the clean batch, run the eval-mode
    forward (running batch-norm statistics, no dropout, no gradients) and
    return per-graph (B,) loss components plus ``t``, so the caller can
    bucket by sigma interval and drop repeat-padded rows.  Built with a
    ``shard``, each rank runs its rows of the global batch and draws, and
    every rank gets the per-graph values of all rows in row order (those of
    ``diffphore_tpu.parallel.mesh.shard_eval_step``)."""
    schedule = cfg.sigma_schedule

    @torch.no_grad()
    def step(model: ScoreModel, batch, generator: Optional[torch.Generator] = None,
             draws: Optional[NoiseDraws] = None):
        if shard is not None:
            B = batch.batch_size
            if draws is None:
                draws = draw_noise(B, batch.num_torsions, generator, batch.device)
            batch, draws = shard_rows(batch, shard.rank, shard.world), draws.rows(shard.rows(B))
        noised, targets = apply_noise(batch, schedule, generator, draws,
                                      no_torsion=cfg.no_torsion)
        model.eval()
        preds = model(noised)
        metrics = score_matching_loss(
            preds, targets, noised.t, batch.tor_mask, schedule,
            tr_weight, rot_weight, tor_weight, cfg.no_torsion, apply_mean=False)
        metrics["t"] = noised.t
        if shard is not None:
            table = shard.gather(torch.stack(list(metrics.values()), dim=1))
            metrics = dict(zip(metrics, table.unbind(1)))
        return metrics

    return step

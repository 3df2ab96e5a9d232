"""Calibrated conformation sampler: inference-aware training.

With probability p(epoch) a training pose is not a plain forward-noised
sample but the result of one reverse Euler step of the current model from t
to t - delta_t; the regression targets are recomputed from the cumulative
0 -> t_n transform, recovered by Kabsch alignment.  The step of the current
model is a second, eval-mode forward without gradients inside the train
step, and the branch is chosen per graph.

p(epoch) follows :func:`dynamic_schedule`:
    p = max_rate * (1 - u / (u + exp(c * epoch / u)))

All randomness enters through :class:`CCDraws`, drawn from a
``torch.Generator`` by default or handed in, so that a step can be replayed
with another framework's numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..data.transforms import NoiseDraws, draw_noise, forward_updates, score_targets
from ..models.score_model import ScoreModelConfig
from ..ops.diffusion import SigmaSchedule
from ..ops.geometry import kabsch, matrix_to_axis_angle
from ..ops.torsion import apply_torsion_updates
from ..parallel.mesh import shard_rows
from ..sampler.sampling import StepNoise, apply_pose_update, draw_steps, sample_step
from .losses import ScoreTargets
from .state import TrainState, optimize


def dynamic_schedule(epoch: int, max_rate: float = 0.4, u: float = 400, c: float = 10) -> float:
    u = max(float(u), 1.0)  # guard epoch_from_infer = 0
    return float(max_rate * (1 - u / (u + np.exp(min(c * epoch / u, 50.0)))))


@dataclasses.dataclass
class CCDraws:
    """The raw draws of one :func:`ccsampler_apply_noise` call."""

    noise: NoiseDraws        # t and the forward noise, one try (K = 1)
    step: StepNoise          # the reverse step's noise: one step, one candidate
    select_u: torch.Tensor   # (B,) uniform: the branch selection

    def rows(self, sl: slice) -> "CCDraws":
        """The draws of the batch rows ``sl``."""
        return CCDraws(self.noise.rows(sl), self.step.rows(sl), self.select_u[sl])


def draw_cc(B: int, T: int, generator: Optional[torch.Generator], device) -> CCDraws:
    return CCDraws(noise=draw_noise(B, T, generator, device),
                   step=draw_steps(1, B, T, generator, device),
                   select_u=torch.rand((B,), generator=generator, device=device))


def cumulative_rigid_transform(batch, tor_cum: torch.Tensor, stepped_pos: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rigid part (tr (B,3), rot (B,3) axis-angle) of the transform from
    the clean pose of ``batch`` to ``stepped_pos``, given the cumulative
    torsions: apply them to the clean pose, align that back onto the clean
    pose, then Kabsch against the stepped pose."""
    pos0, mask = batch.lig_pos, batch.lig_mask
    flex, _ = apply_torsion_updates(pos0, batch.tor_edges, batch.mask_rotate, tor_cum,
                                    batch.tor_mask)
    Rk, tk = kabsch(flex, pos0, mask=mask)
    aligned = torch.einsum("bni,bji->bnj", flex, Rk) + tk[:, None]
    R1, _ = kabsch(aligned, stepped_pos, mask=mask)
    w = mask.to(pos0.dtype)[..., None]
    count = torch.clamp(w.sum(1), min=1.0)
    tr_cum = (stepped_pos * w).sum(1) / count - (aligned * w).sum(1) / count
    return tr_cum, matrix_to_axis_angle(R1)


def ccsampler_apply_noise(
    batch,
    schedule: SigmaSchedule,
    score_fn: Callable,
    p_from_infer: float,
    delta_t: float = 0.05,
    no_torsion: bool = False,
    generator: Optional[torch.Generator] = None,
    draws: Optional[CCDraws] = None,
) -> Tuple[object, ScoreTargets, torch.Tensor]:
    """Noise a clean batch with a per-graph mix of plain diffusion and
    one-model-step calibrated samples.

    ``score_fn`` is the current model's score function (batch -> tr, rot,
    tor), called once on the forward-noised batch; ``p_from_infer`` the
    probability of the calibrated branch per graph, which a graph takes only
    when its t exceeds ``delta_t``.  Returns (noised batch, targets, use_cc
    (B,) bool).
    """
    B, T = batch.lig_pos.shape[0], batch.tor_edges.shape[1]
    if draws is None:
        draws = draw_cc(B, T, generator, batch.device)

    # ---- forward noise at t (the drawn updates are kept)
    t, sigmas, ups = forward_updates(batch, schedule, draws.noise, no_torsion)
    noised = apply_pose_update(batch, *ups).replace(t=t)

    # ---- one reverse Euler step of the current model: t -> t - delta_t
    stepped, _, _, tor_p = sample_step(score_fn, noised, schedule, *sigmas, delta_t=delta_t,
                                       noise=draws.step)
    tor_cum = ups[2] + tor_p * batch.tor_mask

    # ---- the cumulative rigid transform 0 -> t_n, and the sample at t_n
    # rebuilt from the clean pose with the cumulative updates
    tr_cum, rot_cum = cumulative_rigid_transform(batch, tor_cum, stepped.lig_pos)
    t_n = torch.clamp(t - delta_t, min=1e-3)
    rebuilt = apply_pose_update(batch, tr_cum, rot_cum, tor_cum)

    # ---- per-graph branch selection
    use_cc = (draws.select_u < p_from_infer) & (t > delta_t)

    def sel(a, b):
        return torch.where(use_cc.reshape((B,) + (1,) * (a.dim() - 1)), a, b)

    out = noised.replace(lig_pos=sel(rebuilt.lig_pos, noised.lig_pos),
                         lig_norm=sel(rebuilt.lig_norm, noised.lig_norm), t=sel(t_n, t))
    sigmas_eff = tuple(sel(n, s) for n, s in zip(schedule(t_n), sigmas))
    ups_eff = tuple(sel(c, u) for c, u in zip((tr_cum, rot_cum, tor_cum), ups))
    return out, score_targets(sigmas_eff, ups_eff, batch.tor_mask), use_cc


def make_ccsampler_train_step(cfg: ScoreModelConfig, ema_decay: float = 0.999,
                              tr_weight: float = 0.33, rot_weight: float = 0.33,
                              tor_weight: float = 0.33, delta_t: float = 0.05,
                              shard=None) -> Callable:
    """Build ``step(state, batch, generator=None, p_from_infer=0.0, draws=None)
    -> (state, metrics)``: the train step with the calibrated branch.  The
    reverse step inside it is a forward of the current weights in eval mode
    (running batch-norm statistics, no dropout) without gradients; the rest
    is :func:`diffphore_torch.train.state.optimize`.  ``metrics`` also hold
    ``cc_share``, the share of graphs that took the calibrated branch.  Built
    with a ``shard`` (``parallel.mesh.DataShard``), the step takes the global
    batch and its draws and keeps this rank's rows of both, as
    ``train.state.make_train_step`` does."""
    schedule = cfg.sigma_schedule

    def step(state: TrainState, batch, generator: Optional[torch.Generator] = None,
             p_from_infer: float = 0.0, draws: Optional[CCDraws] = None):
        model = state.model
        model.eval()
        with torch.no_grad():
            B = batch.batch_size
            if shard is not None:
                if draws is None:
                    draws = draw_cc(B, batch.num_torsions, generator, batch.device)
                batch, draws = shard_rows(batch, shard.rank, shard.world), draws.rows(
                    shard.rows(B))
            noised, targets, use_cc = ccsampler_apply_noise(
                batch, schedule, model, p_from_infer, delta_t, cfg.no_torsion, generator, draws)
        state, metrics = optimize(state, cfg, noised, targets, batch, generator, ema_decay,
                                  tr_weight, rot_weight, tor_weight, shard)
        use_cc = use_cc.to(torch.float32)
        metrics["cc_share"] = use_cc.mean() if shard is None else shard.sum(use_cc.sum()) / B
        return state, metrics

    return step

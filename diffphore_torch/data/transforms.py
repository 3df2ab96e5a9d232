"""Forward-diffusion noise transform, on the batch's device.

A clean batch is noised inside the train step: per-graph t ~ U(0, 1),
tr ~ N(0, sigma_tr), rot ~ IGSO3(sigma_rot), tor ~ N(0, sigma_tor); the
matching score targets come from the device-resident tables.  The draws
come from a ``torch.Generator`` or are handed in (:class:`NoiseDraws`), so
that a step can be replayed with another framework's numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..ops import so3, torus
from ..ops.diffusion import SigmaSchedule
from ..sampler.sampling import apply_pose_update
from ..train.losses import ScoreTargets

MAX_REJECT_TRIES = 8


@dataclasses.dataclass
class NoiseDraws:
    """The raw draws of one :func:`apply_noise` call with K tries (K = 1
    without rejection)."""

    t: torch.Tensor         # (B,) uniform on [0, 1)
    z_tr: torch.Tensor      # (K, B, 3) standard normal
    rot_axis: torch.Tensor  # (K, B, 3) standard normal, normalized to the axis
    rot_u: torch.Tensor     # (K, B) uniform: the angle's inverse-CDF draw
    z_tor: torch.Tensor     # (K, B, T) standard normal
    reject_u: Optional[torch.Tensor] = None  # (2, K, B) uniform, with rejection

    def rows(self, sl: slice) -> "NoiseDraws":
        """The draws of the batch rows ``sl``."""
        return NoiseDraws(t=self.t[sl], z_tr=self.z_tr[:, sl], rot_axis=self.rot_axis[:, sl],
                          rot_u=self.rot_u[:, sl], z_tor=self.z_tor[:, sl],
                          reject_u=None if self.reject_u is None else self.reject_u[:, :, sl])


def draw_noise(B: int, T: int, generator: Optional[torch.Generator], device,
               reject: bool = False) -> NoiseDraws:
    K = MAX_REJECT_TRIES if reject else 1

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=device)

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=device)

    return NoiseDraws(t=rand(B), z_tr=randn(K, B, 3), rot_axis=randn(K, B, 3), rot_u=rand(K, B),
                      z_tor=randn(K, B, T), reject_u=rand(2, K, B) if reject else None)


def forward_updates(batch, schedule: SigmaSchedule, draws: NoiseDraws, no_torsion: bool = False,
                    reject_prob: float = 0.0):
    """The forward-diffusion updates the draws stand for: (t, (tr_sigma,
    rot_sigma, tor_sigma), (tr (B,3), rot (B,3), tor (B,T))), after the
    curriculum rejection when ``reject_prob`` > 0 and with masked torsions."""
    B = batch.lig_pos.shape[0]
    reject = reject_prob > 0
    K = draws.z_tr.shape[0]
    if reject and draws.reject_u is None:
        raise ValueError("apply_noise: reject_prob > 0 needs draws made with reject=True")
    t = draws.t
    tr_sigma, rot_sigma, tor_sigma = schedule(t)

    tr_draws = tr_sigma[None, :, None] * draws.z_tr
    rot_draws = so3.sample_vec(rot_sigma[None, :].expand(K, B), axis=draws.rot_axis,
                               u=draws.rot_u)
    tor_draws = tor_sigma[None, :, None] * draws.z_tor

    if reject:
        x1, x2 = draws.reject_u[0], draws.reject_u[1]
        tor_mask = batch.tor_mask.to(tr_draws.dtype)
        T_ = torch.linalg.norm(tr_draws, dim=-1) / tr_sigma
        R_ = torch.linalg.norm(rot_draws, dim=-1) / rot_sigma
        n_tor = torch.clamp(tor_mask.sum(-1), min=1.0)
        Theta_ = (torch.abs(tor_draws) * tor_mask).sum(-1) / n_tor / tor_sigma
        has_tor = batch.tor_mask.any(-1)
        rej = (x1 <= reject_prob) & ((T_ > R_) | (has_tor & (T_ > Theta_)))
        rej = rej | ((x2 <= reject_prob) & has_tor & (R_ > Theta_))
        # first accepted draw per row; fall back to the last draw
        accept = ~rej
        first = torch.argmax(accept.to(torch.int32), dim=0)
        first = torch.where(accept.any(0), first, torch.full_like(first, K - 1))
    else:
        first = torch.zeros((B,), dtype=torch.long, device=t.device)

    def pick(d):
        idx = first.reshape((1, B) + (1,) * (d.dim() - 2)).expand((1,) + d.shape[1:])
        return torch.gather(d, 0, idx)[0]

    tr_update, rot_update, tor_update = pick(tr_draws), pick(rot_draws), pick(tor_draws)
    if no_torsion:
        tor_update = torch.zeros_like(tor_update)
    tor_update = tor_update * batch.tor_mask
    return t, (tr_sigma, rot_sigma, tor_sigma), (tr_update, rot_update, tor_update)


def score_targets(sigmas, updates, tor_mask: torch.Tensor) -> ScoreTargets:
    """The regression targets of updates drawn at the given sigmas:
    tr_score = -tr / sigma^2, rot_score = the IGSO3 score at the rotation,
    tor_score = the wrapped-normal score at the torsions."""
    (tr_sigma, rot_sigma, tor_sigma), (tr, rot, tor) = sigmas, updates
    return ScoreTargets(
        tr_score=-tr / tr_sigma[:, None] ** 2,
        rot_score=so3.score_vec(rot_sigma, rot),
        tor_score=torus.score(tor, tor_sigma[:, None]) * tor_mask,
        tor_sigma=tor_sigma,
    )


def apply_noise(
    batch,
    schedule: SigmaSchedule,
    generator: Optional[torch.Generator] = None,
    draws: Optional[NoiseDraws] = None,
    no_torsion: bool = False,
    reject_prob: float = 0.0,
) -> Tuple[object, ScoreTargets]:
    """Noise a clean batch and return (noised batch, score targets).

    ``reject_prob`` > 0 enables the curriculum rejection: with that
    probability a draw whose normalized translation magnitude exceeds the
    rotation or torsion magnitudes (or rotation exceeds torsion) is redrawn,
    as MAX_REJECT_TRIES vectorized draws with first-accepted selection.
    """
    if draws is None:
        draws = draw_noise(batch.lig_pos.shape[0], batch.tor_edges.shape[1], generator,
                           batch.device, reject_prob > 0)
    t, sigmas, updates = forward_updates(batch, schedule, draws, no_torsion, reject_prob)
    noised = apply_pose_update(batch, *updates).replace(t=t)
    return noised, score_targets(sigmas, updates, batch.tor_mask)

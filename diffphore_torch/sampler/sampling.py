"""Reverse diffusion over T(3) x SO(3) x SO(2)^m: the prior draw and the
reverse SDE with Euler-Maruyama steps.  Poses are rows of one batch.

All randomness enters through explicit noise tensors (:class:`PriorNoise`,
:class:`StepNoise`), drawn from a ``torch.Generator`` by default or handed
in by the caller, so that a run can be replayed with another framework's
draws.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..ops.diffusion import SigmaSchedule, t_schedule
from ..ops.geometry import matrix_to_axis_angle, quaternion_to_matrix
from ..ops.rigid import modify_conformer


@dataclasses.dataclass(frozen=True)
class SamplerSettings:
    inference_steps: int = 20
    #: run only the first ``actual_steps`` steps of the schedule (None = all)
    actual_steps: Optional[int] = None
    no_random: bool = False
    no_final_step_noise: bool = False
    #: the probability-flow ODE update (half the drift, no noise)
    ode: bool = False
    no_torsion: bool = False
    #: > 1 with a fitness function: that many candidate noise draws per step,
    #: the best-scoring pose of each row kept
    random_samples: int = 1

    @property
    def steps(self) -> int:
        return self.actual_steps or self.inference_steps

    @property
    def candidates(self) -> int:
        """Noise draws per step and row (the ODE has none to choose from)."""
        return 1 if self.ode else max(self.random_samples, 1)


@dataclasses.dataclass
class PriorNoise:
    tor: torch.Tensor   # (B, T) uniform on [-pi, pi)
    quat: torch.Tensor  # (B, 4) standard normal
    tr: torch.Tensor    # (B, 3) standard normal


@dataclasses.dataclass
class StepNoise:
    """Standard normal draws of ``steps`` steps with S candidates each."""

    z_tr: torch.Tensor   # (steps, S, B, 3)
    z_rot: torch.Tensor  # (steps, S, B, 3)
    z_tor: torch.Tensor  # (steps, S, B, T)

    def rows(self, sl: slice) -> "StepNoise":
        """The draws of the batch rows ``sl``."""
        return StepNoise(self.z_tr[:, :, sl], self.z_rot[:, :, sl], self.z_tor[:, :, sl])


def draw_prior(B: int, T: int, generator: torch.Generator, device) -> PriorNoise:
    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device)

    tor = torch.rand((B, T), generator=generator, device=device) * (2 * math.pi) - math.pi
    return PriorNoise(tor=tor, quat=normal(B, 4), tr=normal(B, 3))


def draw_steps(steps: int, B: int, T: int, generator: Optional[torch.Generator], device,
               candidates: int = 1) -> StepNoise:
    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device)

    S = candidates
    return StepNoise(z_tr=normal(steps, S, B, 3), z_rot=normal(steps, S, B, 3),
                     z_tor=normal(steps, S, B, T))


def apply_pose_update(batch, tr: torch.Tensor, rot: torch.Tensor, tor: torch.Tensor):
    pos, norm = modify_conformer(batch.lig_pos, batch.lig_norm, batch.lig_mask, batch.tor_edges,
                                 batch.mask_rotate, batch.tor_mask, tr, rot, tor)
    return batch.replace(lig_pos=pos, lig_norm=norm)


def randomize_position(batch, noise: PriorNoise, tr_sigma_max: float = 5.0,
                       no_torsion: bool = False, no_random: bool = False):
    """The t = 1 prior pose: uniform torsions (none with ``no_torsion``), a
    uniform SO(3) orientation about the ligand centroid, N(0, tr_sigma_max)
    translation (none with ``no_random``)."""
    quat = noise.quat / torch.linalg.norm(noise.quat, dim=-1, keepdim=True)
    rot = matrix_to_axis_angle(quaternion_to_matrix(quat))
    m = batch.lig_mask.to(batch.lig_pos.dtype)
    center = (batch.lig_pos * m[..., None]).sum(1) / torch.clamp(m.sum(1), min=1.0)[:, None]
    tor = torch.zeros_like(noise.tor) if no_torsion else noise.tor
    tr = torch.zeros_like(noise.tr) if no_random else tr_sigma_max * noise.tr
    return apply_pose_update(batch, tr - center, rot, tor)


def euler_updates(score_fn: Callable, batch, schedule: SigmaSchedule,
                  sigmas: Tuple[torch.Tensor, torch.Tensor, torch.Tensor], dt: float,
                  z_tr: torch.Tensor, z_rot: torch.Tensor, z_tor: torch.Tensor,
                  ode: bool = False, no_torsion: bool = False):
    """The updates (tr_p, rot_p, tor_p) of one Euler step of the reverse SDE
    (or, with ``ode``, of the probability-flow ODE) from ``batch``: one
    score-model forward, per-graph ``sigmas`` (B,) each, step ``dt`` taken as
    f32.  z_* are the step's noise, (B, .) or with leading candidate axes,
    which the updates then carry too; already zeroed where the step has none."""
    dt32 = float(np.float32(dt))
    sqrt_dt = float(np.sqrt(np.float32(dt)))
    scores = [torch.nan_to_num(s, nan=0.0, posinf=0.0, neginf=0.0) for s in score_fn(batch)]
    gs = [g(sigma)[:, None] for g, sigma in zip((schedule.g_tr, schedule.g_rot, schedule.g_tor),
                                                sigmas)]
    if ode:
        tr_p, rot_p, tor_p = (0.5 * g**2 * dt32 * s for g, s in zip(gs, scores))
    else:
        tr_p, rot_p, tor_p = (g**2 * dt32 * s + g * sqrt_dt * z
                              for g, s, z in zip(gs, scores, (z_tr, z_rot, z_tor)))
    if no_torsion:
        tor_p = torch.zeros_like(tor_p)
    # torsion updates are angles (wrapping is exact); translation and
    # rotation magnitudes are bounded far above a trained model's
    tor_p = torch.remainder(tor_p + math.pi, 2 * math.pi) - math.pi
    tr_p = torch.clamp(tr_p, -50.0, 50.0)
    rot_p = torch.clamp(rot_p, -2 * math.pi, 2 * math.pi)
    tor_p = tor_p * batch.tor_mask
    return tr_p, rot_p, tor_p


def reverse_step(score_fn: Callable, batch, t: float, dt: float,
                 z_tr: torch.Tensor, z_rot: torch.Tensor, z_tor: torch.Tensor,
                 schedule: SigmaSchedule, ode: bool = False, no_torsion: bool = False):
    """One Euler-Maruyama step of the reverse SDE at time t with step dt,
    both taken as f32; z_* (B, .) are the step's noise, already zeroed where
    the step has none.  Returns (batch', tr_p, rot_p, tor_p)."""
    B = batch.lig_pos.shape[0]
    bt = torch.full((B,), float(np.float32(t)), dtype=torch.float32, device=batch.device)
    batch = batch.replace(t=bt)
    tr_p, rot_p, tor_p = euler_updates(score_fn, batch, schedule, schedule(bt), dt,
                                       z_tr, z_rot, z_tor, ode, no_torsion)
    return apply_pose_update(batch, tr_p, rot_p, tor_p), tr_p, rot_p, tor_p


def sample_step(score_fn: Callable, batch, schedule: SigmaSchedule, tr_sigma: torch.Tensor,
                rot_sigma: torch.Tensor, tor_sigma: torch.Tensor, delta_t: float = 0.05,
                no_random: bool = False, ode: bool = False,
                noise: Optional[StepNoise] = None,
                generator: Optional[torch.Generator] = None):
    """One Euler step at given per-graph sigmas (B,) and a fixed ``delta_t``,
    from ``batch`` as it stands (its ``t`` is not touched): the building
    block of the calibrated conformation sampler.  ``noise`` is one step of
    one candidate (drawn from ``generator`` when None).  Returns
    (batch', tr_p, rot_p, tor_p)."""
    B, T = batch.lig_pos.shape[0], batch.tor_edges.shape[1]
    if noise is None:
        noise = draw_steps(1, B, T, generator, batch.device)
    on = 0.0 if no_random else 1.0
    tr_p, rot_p, tor_p = euler_updates(
        score_fn, batch, schedule, (tr_sigma, rot_sigma, tor_sigma), delta_t,
        noise.z_tr[0, 0] * on, noise.z_rot[0, 0] * on, noise.z_tor[0, 0] * on, ode)
    return apply_pose_update(batch, tr_p, rot_p, tor_p), tr_p, rot_p, tor_p


def reverse_diffusion(score_fn: Callable, batch, schedule: SigmaSchedule,
                      settings: SamplerSettings, noise: StepNoise,
                      fitness_fn: Optional[Callable] = None, return_trajectory: bool = False):
    """Run the reverse SDE (or ODE) from t = 1.  ``score_fn``: batch ->
    (tr (B,3), rot (B,3), tor (B,T)).  With ``settings.random_samples`` > 1
    and ``fitness_fn`` (batch -> (B,) fitness) every step applies each of
    the S candidate noise draws to the one forward's scores and keeps, per
    row, the pose of the highest fitness; without a fitness function the
    first candidate is taken.  Returns the final batch, and with
    ``return_trajectory`` the (steps, B, A, 3) positions after each step."""
    steps = settings.steps
    ts = t_schedule(settings.inference_steps)[:steps]
    dts = np.diff(np.append(ts, 0.0)) * -1.0
    S = settings.candidates
    if noise.z_tr.dim() != 4 or noise.z_tr.shape[0] < steps or noise.z_tr.shape[1] < S:
        raise ValueError(f"reverse_diffusion: noise {tuple(noise.z_tr.shape)} does not hold "
                         f"{steps} steps of {S} candidates")
    B = batch.lig_pos.shape[0]
    rows = torch.arange(B, device=batch.device)
    trajectory = []
    for i in range(steps):
        last = i == steps - 1
        on = 0.0 if settings.no_random or (settings.no_final_step_noise and last) else 1.0
        z = [zs[i, :S] * on for zs in (noise.z_tr, noise.z_rot, noise.z_tor)]
        if S == 1 or fitness_fn is None:
            batch, _, _, _ = reverse_step(score_fn, batch, ts[i], dts[i], *(v[0] for v in z),
                                          schedule, settings.ode, settings.no_torsion)
        else:
            bt = torch.full((B,), float(np.float32(ts[i])), dtype=torch.float32,
                            device=batch.device)
            batch = batch.replace(t=bt)
            tr_p, rot_p, tor_p = euler_updates(score_fn, batch, schedule, schedule(bt), dts[i],
                                               *z, settings.ode, settings.no_torsion)
            cands = [apply_pose_update(batch, tr_p[s], rot_p[s], tor_p[s]) for s in range(S)]
            best = torch.argmax(torch.stack([fitness_fn(c) for c in cands]), dim=0)   # (B,)
            batch = batch.replace(
                lig_pos=torch.stack([c.lig_pos for c in cands])[best, rows],
                lig_norm=torch.stack([c.lig_norm for c in cands])[best, rows])
        if return_trajectory:
            trajectory.append(batch.lig_pos)
    if return_trajectory:
        return batch, torch.stack(trajectory)
    return batch

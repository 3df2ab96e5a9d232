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
from typing import Callable

import numpy as np
import torch

from ..ops.diffusion import SigmaSchedule, t_schedule
from ..ops.geometry import matrix_to_axis_angle, quaternion_to_matrix
from ..ops.rigid import modify_conformer


@dataclasses.dataclass(frozen=True)
class SamplerSettings:
    inference_steps: int = 20
    no_final_step_noise: bool = False


@dataclasses.dataclass
class PriorNoise:
    tor: torch.Tensor   # (B, T) uniform on [-pi, pi)
    quat: torch.Tensor  # (B, 4) standard normal
    tr: torch.Tensor    # (B, 3) standard normal


@dataclasses.dataclass
class StepNoise:
    z_tr: torch.Tensor   # (steps, B, 3) standard normal
    z_rot: torch.Tensor  # (steps, B, 3)
    z_tor: torch.Tensor  # (steps, B, T)


def draw_prior(B: int, T: int, generator: torch.Generator, device) -> PriorNoise:
    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device)

    tor = torch.rand((B, T), generator=generator, device=device) * (2 * math.pi) - math.pi
    return PriorNoise(tor=tor, quat=normal(B, 4), tr=normal(B, 3))


def draw_steps(steps: int, B: int, T: int, generator: torch.Generator, device) -> StepNoise:
    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device)

    return StepNoise(z_tr=normal(steps, B, 3), z_rot=normal(steps, B, 3), z_tor=normal(steps, B, T))


def apply_pose_update(batch, tr: torch.Tensor, rot: torch.Tensor, tor: torch.Tensor):
    pos, norm = modify_conformer(batch.lig_pos, batch.lig_norm, batch.lig_mask, batch.tor_edges,
                                 batch.mask_rotate, batch.tor_mask, tr, rot, tor)
    return batch.replace(lig_pos=pos, lig_norm=norm)


def randomize_position(batch, noise: PriorNoise, tr_sigma_max: float = 5.0):
    """The t = 1 prior pose: uniform torsions, a uniform SO(3) orientation
    about the ligand centroid, N(0, tr_sigma_max) translation."""
    quat = noise.quat / torch.linalg.norm(noise.quat, dim=-1, keepdim=True)
    rot = matrix_to_axis_angle(quaternion_to_matrix(quat))
    m = batch.lig_mask.to(batch.lig_pos.dtype)
    center = (batch.lig_pos * m[..., None]).sum(1) / torch.clamp(m.sum(1), min=1.0)[:, None]
    return apply_pose_update(batch, tr_sigma_max * noise.tr - center, rot, noise.tor)


def reverse_step(score_fn: Callable, batch, t: float, dt: float,
                 z_tr: torch.Tensor, z_rot: torch.Tensor, z_tor: torch.Tensor,
                 schedule: SigmaSchedule):
    """One Euler-Maruyama step of the reverse SDE at time t with step dt,
    both taken as f32; z_* are the step's noise, already zeroed where the
    step has none.  Returns (batch', tr_p, rot_p, tor_p)."""
    B = batch.lig_pos.shape[0]
    t32, dt32 = float(np.float32(t)), float(np.float32(dt))
    sqrt_dt = float(np.sqrt(np.float32(dt)))
    bt = torch.full((B,), t32, dtype=torch.float32, device=batch.device)
    batch = batch.replace(t=bt)
    tr_sigma, rot_sigma, tor_sigma = schedule(bt)
    tr_score, rot_score, tor_score = (
        torch.nan_to_num(s, nan=0.0, posinf=0.0, neginf=0.0) for s in score_fn(batch))
    g_tr = schedule.g_tr(tr_sigma)[:, None]
    g_rot = schedule.g_rot(rot_sigma)[:, None]
    g_tor = schedule.g_tor(tor_sigma)[:, None]
    tr_p = g_tr**2 * dt32 * tr_score + g_tr * sqrt_dt * z_tr
    rot_p = g_rot**2 * dt32 * rot_score + g_rot * sqrt_dt * z_rot
    tor_p = g_tor**2 * dt32 * tor_score + g_tor * sqrt_dt * z_tor
    # torsion updates are angles (wrapping is exact); translation and
    # rotation magnitudes are bounded far above a trained model's
    tor_p = torch.remainder(tor_p + math.pi, 2 * math.pi) - math.pi
    tr_p = torch.clamp(tr_p, -50.0, 50.0)
    rot_p = torch.clamp(rot_p, -2 * math.pi, 2 * math.pi)
    tor_p = tor_p * batch.tor_mask
    return apply_pose_update(batch, tr_p, rot_p, tor_p), tr_p, rot_p, tor_p


def reverse_diffusion(score_fn: Callable, batch, schedule: SigmaSchedule,
                      settings: SamplerSettings, noise: StepNoise):
    """Run the reverse SDE from t = 1.  ``score_fn``: batch ->
    (tr (B,3), rot (B,3), tor (B,T)).  Returns the final batch."""
    steps = settings.inference_steps
    ts = t_schedule(steps)
    dts = np.diff(np.append(ts, 0.0)) * -1.0
    for i in range(steps):
        last = i == steps - 1
        on = 0.0 if settings.no_final_step_noise and last else 1.0
        batch, _, _, _ = reverse_step(
            score_fn, batch, ts[i], dts[i], noise.z_tr[i] * on, noise.z_rot[i] * on,
            noise.z_tor[i] * on, schedule)
    return batch

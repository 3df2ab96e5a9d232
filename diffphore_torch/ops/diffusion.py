"""Diffusion schedule, sigma interpolation and timestep embeddings."""

from __future__ import annotations

import dataclasses
import functools
import math
import os

import numpy as np
import torch

#: the raw normal draws of the JAX package's Fourier projections (row h - 1:
#: half-width h), written by analysis/write_fourier_table.py
FOURIER_TABLE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "fourier_projection.npz")


@dataclasses.dataclass(frozen=True)
class SigmaSchedule:
    """Geometric interpolation sigma(t) = min^(1-t) * max^t per group."""

    tr_sigma_min: float = 0.1
    tr_sigma_max: float = 5.0
    rot_sigma_min: float = 0.1
    rot_sigma_max: float = 1.5
    tor_sigma_min: float = 0.0314
    tor_sigma_max: float = 3.14

    def __call__(self, t_tr, t_rot=None, t_tor=None):
        t_rot = t_tr if t_rot is None else t_rot
        t_tor = t_tr if t_tor is None else t_tor
        tr = self.tr_sigma_min ** (1 - t_tr) * self.tr_sigma_max**t_tr
        rot = self.rot_sigma_min ** (1 - t_rot) * self.rot_sigma_max**t_rot
        tor = self.tor_sigma_min ** (1 - t_tor) * self.tor_sigma_max**t_tor
        return tr, rot, tor

    # SDE diffusion coefficients g(t)
    def g_tr(self, tr_sigma):
        return tr_sigma * math.sqrt(2.0 * math.log(self.tr_sigma_max / self.tr_sigma_min))

    def g_rot(self, rot_sigma):
        return 2.0 * rot_sigma * math.sqrt(math.log(self.rot_sigma_max / self.rot_sigma_min))

    def g_tor(self, tor_sigma):
        return tor_sigma * math.sqrt(2.0 * math.log(self.tor_sigma_max / self.tor_sigma_min))


def t_schedule(inference_steps: int) -> np.ndarray:
    """linspace(1 -> 0), endpoint dropped."""
    return np.linspace(1.0, 0.0, inference_steps + 1)[:-1]


def embedding_frequencies(half: int, max_positions: int, device) -> torch.Tensor:
    """The sinusoidal embedding's f32 frequencies exp(-log(max_positions) * i /
    (half - 1)): the f32 exponents, formed as the JAX package forms them,
    raised in f64 and rounded once, which is what the CPU's f32 exp gives at
    the shipped widths.  Every device then holds the same table.  A device's
    own f32 exp may stand one ulp off, and the phase ``embedding_scale * t *
    freq`` (up to 1e4) carries one ulp of a low frequency to 3e-4 of the
    score model's outputs."""
    exponent = (torch.arange(half, dtype=torch.float32, device=device)
                * (-math.log(max_positions) / (half - 1)))
    return torch.exp(exponent.double()).float()


def sinusoidal_embedding(t: torch.Tensor, embedding_dim: int,
                         max_positions: int = 10000) -> torch.Tensor:
    """Transformer-style sinusoidal embedding of (fractional) steps."""
    freq = embedding_frequencies(embedding_dim // 2, max_positions, t.device)
    emb = t[..., None].to(torch.float32) * freq
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if embedding_dim % 2 == 1:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb


@functools.lru_cache(maxsize=None)
def fourier_draws(half: int) -> np.ndarray:
    """The JAX package's ``jax.random.normal(PRNGKey(0), (half,))``, read
    from :data:`FOURIER_TABLE`; raises for a half-width the table lacks."""
    with np.load(FOURIER_TABLE) as z:
        table = z["normal"]
    if not 1 <= half <= table.shape[0]:
        raise ValueError(f"Fourier embedding half-width {half}: the table holds 1 to "
                         f"{table.shape[0]}")
    return table[half - 1, :half].copy()


def gaussian_fourier_embedding(t: torch.Tensor, embedding_dim: int,
                               scale: float = 1.0) -> torch.Tensor:
    """Gaussian Fourier embedding: [sin, cos] of 2 pi t W with a frozen
    projection W ~ N(0, scale^2) of embedding_dim // 2 entries, the JAX
    package's draws."""
    w = torch.as_tensor(fourier_draws(embedding_dim // 2), device=t.device) * scale
    proj = t[..., None].to(torch.float32) * w * (2.0 * math.pi)
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)


def timestep_embedding(embedding_type: str, embedding_dim: int, embedding_scale: float = 10000):
    """'sinusoidal' (of embedding_scale * t) or 'fourier' (projections of
    scale embedding_scale)."""
    if embedding_type == "sinusoidal":
        return lambda t: sinusoidal_embedding(embedding_scale * t, embedding_dim)
    if embedding_type == "fourier":
        return lambda t: gaussian_fourier_embedding(t, embedding_dim, embedding_scale)
    raise NotImplementedError(embedding_type)

"""Wrapped-normal (torus) tables: the torsion-score scaling
(``score_norm``), and the density and score on the (sigma, x) grid for the
training targets.

Same grid and series as the JAX package (1024 x 1024 log-spaced grid, 16
wrapped images, trapezoid quadrature of E[score^2]).
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch

from .tables import cached_tables

X_MIN = 1e-5
SIGMA_MIN, SIGMA_MAX = 3e-3, 2.0
X_N = 1024
SIGMA_N = 1024
_N_IMAGES = 16


def _build_tables() -> dict:
    x = 10.0 ** np.linspace(np.log10(X_MIN), 0, X_N + 1) * np.pi
    sigma = 10.0 ** np.linspace(np.log10(SIGMA_MIN), np.log10(SIGMA_MAX), SIGMA_N + 1) * np.pi

    p = np.zeros((SIGMA_N + 1, X_N + 1))
    # stable score: factor out the dominant image's exponent so grad/p never
    # becomes 0/0 at small sigma
    p_shift = np.zeros_like(p)
    grad_shift = np.zeros_like(p)
    inv_var = 1.0 / sigma[:, None] ** 2
    images = np.arange(-_N_IMAGES, _N_IMAGES + 1)
    z = x[None, :] + 2.0 * np.pi * images[:, None, None]
    z2_min = (z**2).min(axis=0)
    for i in range(len(images)):
        xi = z[i]
        p += np.exp(-0.5 * xi**2 * inv_var)
        e_s = np.exp(-0.5 * (xi**2 - z2_min) * inv_var)
        p_shift += e_s
        grad_shift += xi * inv_var * e_s
    score = grad_shift / p_shift

    num = np.trapezoid(p * score**2, x, axis=1)
    den = np.trapezoid(p, x, axis=1)
    return {
        "p": p.astype(np.float32),
        "score": score.astype(np.float32),
        "score_norm": (num / den).astype(np.float32),
    }


@functools.lru_cache(maxsize=1)
def _tables() -> dict:
    return cached_tables(f"torus_tables_{SIGMA_N}x{X_N}", _build_tables)


@functools.lru_cache(maxsize=None)
def _device_table(device: str, name: str = "score_norm") -> torch.Tensor:
    return torch.as_tensor(_tables()[name], device=device)


def _x_idx(x: torch.Tensor) -> torch.Tensor:
    xx = torch.log(torch.clamp(torch.abs(x), min=1e-30) / math.pi)
    xx = (xx - np.log(X_MIN)) / (0.0 - np.log(X_MIN)) * X_N
    return torch.clamp(torch.round(xx), 0, X_N).long()


def _sigma_idx(sigma: torch.Tensor) -> torch.Tensor:
    s = torch.log(sigma / math.pi)
    s = (s - np.log(SIGMA_MIN)) / (np.log(SIGMA_MAX) - np.log(SIGMA_MIN)) * SIGMA_N
    return torch.clamp(torch.round(s), 0, SIGMA_N).long()


def score_norm(sigma: torch.Tensor) -> torch.Tensor:
    """E[score^2] per sigma."""
    table = _device_table(str(sigma.device))
    return table[_sigma_idx(sigma)]


def wrap(x: torch.Tensor) -> torch.Tensor:
    """Wrap angles to [-pi, pi)."""
    return torch.remainder(x + math.pi, 2.0 * math.pi) - math.pi


def score(x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """d/dx log p_wrapped-normal(x; sigma); x broadcasts against sigma."""
    x = wrap(x)
    x, sigma = torch.broadcast_tensors(x, sigma)
    table = _device_table(str(x.device), "score")
    return -torch.sign(x) * table[_sigma_idx(sigma), _x_idx(x)]


def p(x: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Unnormalized wrapped-normal density at x."""
    x, sigma = torch.broadcast_tensors(wrap(x), sigma)
    return _device_table(str(x.device), "p")[_sigma_idx(sigma), _x_idx(x)]


def sample(sigma: torch.Tensor, generator: Optional[torch.Generator] = None,
           z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """wrap(sigma * N(0, 1)); ``z``: the standard normals, drawn from
    ``generator`` when not handed in."""
    if z is None:
        z = torch.randn(sigma.shape, generator=generator, device=sigma.device)
    return wrap(sigma * z)

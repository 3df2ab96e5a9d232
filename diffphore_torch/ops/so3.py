"""IGSO(3) score-norm table: the rotation-score scaling of the score model.

Same truncated series and grid as the JAX package (512 epsilons, 1024
angles, 2000 terms), so the float32 table is the same.  Inference reads
only ``exp_score_norms``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .tables import cached_tables

MIN_EPS, MAX_EPS = 0.01, 2.0
N_EPS = 512
X_N = 1024
_L_TRUNC = 2000


def _build_tables() -> dict:
    eps = 10.0 ** np.linspace(np.log10(MIN_EPS), np.log10(MAX_EPS), N_EPS)
    omega = np.linspace(0, np.pi, X_N + 1)[1:]
    ls = np.arange(_L_TRUNC, dtype=np.float64)

    # E[e, l] = exp(-l(l+1) eps_e^2);  expansion = E @ S  with
    # S[l, w] = (2l+1) sin(w(l+1/2)) / sin(w/2)
    E = np.exp(-ls[None, :] * (ls[None, :] + 1.0) * (eps[:, None] ** 2))
    half = ls + 0.5
    lo = np.sin(omega / 2.0)[None, :]
    hi = np.sin(np.outer(half, omega))
    S = (2.0 * ls[:, None] + 1.0) * hi / lo
    expansion = E @ S

    dhi = half[:, None] * np.cos(np.outer(half, omega))
    dlo = 0.5 * np.cos(omega / 2.0)[None, :]
    S2 = (2.0 * ls[:, None] + 1.0) * (lo * dhi - hi * dlo) / lo**2
    score_norms = (E @ S2) / expansion

    pdf = expansion * (1.0 - np.cos(omega)[None, :]) / np.pi
    exp_score_norms = np.sqrt(
        np.sum(score_norms**2 * pdf, axis=1) / np.sum(pdf, axis=1) / np.pi
    )
    return {"exp_score_norms": exp_score_norms.astype(np.float32)}


@functools.lru_cache(maxsize=1)
def _tables() -> dict:
    return cached_tables(f"so3_exp_score_norms_{N_EPS}x{X_N}", _build_tables)


@functools.lru_cache(maxsize=None)
def _device_table(device: str) -> torch.Tensor:
    return torch.as_tensor(_tables()["exp_score_norms"], device=device)


def _eps_idx(eps: torch.Tensor) -> torch.Tensor:
    """Nearest epsilon-grid index."""
    x = ((torch.log10(eps) - np.log10(MIN_EPS))
         / (np.log10(MAX_EPS) - np.log10(MIN_EPS)) * N_EPS)
    return torch.clamp(torch.round(x).long(), 0, N_EPS - 1)


def score_norm(eps: torch.Tensor) -> torch.Tensor:
    """E[||score||^2]^(1/2) per epsilon."""
    table = _device_table(str(eps.device))
    return table[_eps_idx(eps)]

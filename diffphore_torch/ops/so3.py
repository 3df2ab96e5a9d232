"""IGSO(3) tables: the rotation-score scaling of the score model
(``exp_score_norms``), and what the training noise needs: the angle grid,
its CDF per epsilon (sampling by inverse CDF) and the score magnitude per
(epsilon, angle).

Same truncated series and grid as the JAX package (512 epsilons, 1024
angles, 2000 terms), so the float32 tables are the same.  Random draws come
from a ``torch.Generator`` or are handed in by the caller.
"""

from __future__ import annotations

import functools
from typing import Optional

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
    cdf = np.cumsum(pdf, axis=1) / X_N * np.pi
    exp_score_norms = np.sqrt(
        np.sum(score_norms**2 * pdf, axis=1) / np.sum(pdf, axis=1) / np.pi
    )
    return {
        "omega": omega.astype(np.float32),
        "cdf": cdf.astype(np.float32),
        "score_norms": score_norms.astype(np.float32),
        "exp_score_norms": exp_score_norms.astype(np.float32),
    }


@functools.lru_cache(maxsize=1)
def _tables() -> dict:
    return cached_tables(f"so3_tables_{N_EPS}x{X_N}", _build_tables)


@functools.lru_cache(maxsize=None)
def _device_table(device: str, name: str = "exp_score_norms") -> torch.Tensor:
    return torch.as_tensor(_tables()[name], device=device)


def _eps_idx(eps: torch.Tensor) -> torch.Tensor:
    """Nearest epsilon-grid index."""
    x = ((torch.log10(eps) - np.log10(MIN_EPS))
         / (np.log10(MAX_EPS) - np.log10(MIN_EPS)) * N_EPS)
    return torch.clamp(torch.round(x).long(), 0, N_EPS - 1)


def score_norm(eps: torch.Tensor) -> torch.Tensor:
    """E[||score||^2]^(1/2) per epsilon."""
    table = _device_table(str(eps.device))
    return table[_eps_idx(eps)]


def _interp_rows(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``np.interp`` row by row: x (R,), xp and fp (R, X) or (X,), xp
    increasing along X; edges clamp."""
    R = x.shape[0]
    xp = xp.expand(R, -1).contiguous()
    fp = fp.expand(R, -1)
    i = torch.clamp(torch.searchsorted(xp, x[:, None].contiguous(), right=True),
                    1, xp.shape[1] - 1)
    x0, x1 = xp.gather(1, i - 1)[:, 0], xp.gather(1, i)[:, 0]
    f0, f1 = fp.gather(1, i - 1)[:, 0], fp.gather(1, i)[:, 0]
    dx = x1 - x0
    flat = dx.abs() <= torch.finfo(x.dtype).eps
    f = torch.where(flat, f0, f0 + (x - x0) / torch.where(flat, torch.ones_like(dx), dx)
                    * (f1 - f0))
    f = torch.where(x < xp[:, 0], fp[:, 0], f)
    return torch.where(x > xp[:, -1], fp[:, -1], f)


def sample(eps: torch.Tensor, generator: Optional[torch.Generator] = None,
           u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rotation angles omega ~ IGSO3(eps) by inverse CDF.  ``u``: uniforms on
    [0, 1) of eps's shape, drawn from ``generator`` when not handed in."""
    dev = str(eps.device)
    if u is None:
        u = torch.rand(eps.shape, generator=generator, device=eps.device)
    cdf = _device_table(dev, "cdf")[_eps_idx(eps).reshape(-1)]           # (R, X_N)
    return _interp_rows(u.reshape(-1), cdf, _device_table(dev, "omega")).reshape(eps.shape)


def sample_vec(eps: torch.Tensor, generator: Optional[torch.Generator] = None,
               axis: Optional[torch.Tensor] = None,
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Axis-angle rotation vectors (..., 3) from IGSO3(eps).  ``axis``:
    standard normals (..., 3), normalized here; ``u``: see :func:`sample`."""
    if axis is None:
        axis = torch.randn(eps.shape + (3,), generator=generator, device=eps.device)
    axis = axis / torch.clamp(torch.linalg.norm(axis, dim=-1, keepdim=True), min=1e-12)
    return axis * sample(eps, generator, u)[..., None]


def score_vec(eps: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """Score of the IGSO3 density at rotation vector ``vec`` (..., 3)."""
    dev = str(eps.device)
    om = torch.linalg.norm(vec, dim=-1)
    rows = _device_table(dev, "score_norms")[_eps_idx(eps).reshape(-1)]  # (R, X_N)
    mag = _interp_rows(om.reshape(-1), _device_table(dev, "omega"), rows).reshape(om.shape)
    return mag[..., None] * vec / torch.clamp(om, min=1e-12)[..., None]

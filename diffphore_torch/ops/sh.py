"""Real spherical harmonics up to l = 2, 'component' normalized.

Ordering m = -l..l in the basis of :mod:`.wigner`:
  l=1 -> sqrt(3) * (y, z, x)
  l=2 -> sqrt(15)*xy, sqrt(15)*yz, sqrt(5)/2*(3z^2-1), sqrt(15)*zx,
         sqrt(15)/2*(x^2-y^2)
"""

from __future__ import annotations

import math

import torch

_SQRT3 = math.sqrt(3.0)
_SQRT5 = math.sqrt(5.0)
_SQRT15 = math.sqrt(15.0)


def normalize_vec(vec: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Safe unit-normalization along the last axis."""
    n = torch.linalg.norm(vec, dim=-1, keepdim=True)
    return vec / torch.clamp(n, min=eps)


def sh_l1(unit: torch.Tensor) -> torch.Tensor:
    x, y, z = unit[..., 0], unit[..., 1], unit[..., 2]
    return _SQRT3 * torch.stack([y, z, x], dim=-1)


def sh_l2(unit: torch.Tensor) -> torch.Tensor:
    x, y, z = unit[..., 0], unit[..., 1], unit[..., 2]
    return torch.stack(
        [
            _SQRT15 * x * y,
            _SQRT15 * y * z,
            _SQRT5 * 0.5 * (3.0 * z * z - 1.0),
            _SQRT15 * z * x,
            _SQRT15 * 0.5 * (x * x - y * y),
        ],
        dim=-1,
    )


def irrep1_to_cartesian(v: torch.Tensor) -> torch.Tensor:
    """l=1 irrep feature (m = -1, 0, +1 ~ (y, z, x)) -> Cartesian (x, y, z)."""
    return torch.stack([v[..., 2], v[..., 0], v[..., 1]], dim=-1)


def spherical_harmonics_lmax2(
    vec: torch.Tensor, normalize: bool = True, zero_safe: bool = False
) -> torch.Tensor:
    """Concatenated (Y0 | Y1 | Y2) of shape (..., 9).  ``zero_safe`` maps
    zero-length inputs to an all-zero vector, which keeps rotation
    equivariance for degenerate directions."""
    u = normalize_vec(vec) if normalize else vec
    y0 = torch.ones(u.shape[:-1] + (1,), dtype=u.dtype, device=u.device)
    out = torch.cat([y0, sh_l1(u), sh_l2(u)], dim=-1)
    if zero_safe:
        nz = torch.linalg.norm(vec, dim=-1, keepdim=True) > 1e-8
        out = out * nz
    return out

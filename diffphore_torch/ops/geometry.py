"""Rigid-body geometry: axis-angle rotations, quaternions, and Kabsch
alignment by Horn's quaternion method (eigenvectors of a 4x4 symmetric key
matrix), which always returns a proper rotation and batches trivially."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def quaternion_to_matrix(quat: torch.Tensor) -> torch.Tensor:
    """Quaternions (..., 4) real-first -> rotation matrices (..., 3, 3)."""
    r, i, j, k = torch.unbind(quat, dim=-1)
    two_s = 2.0 / torch.sum(quat * quat, dim=-1)
    o = torch.stack(
        [
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ],
        dim=-1,
    )
    return o.reshape(quat.shape[:-1] + (3, 3))


def axis_angle_to_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle vectors (..., 3) -> rotation matrices (..., 3, 3), with the
    small-angle series below 1e-6 rad."""
    angles = torch.linalg.norm(axis_angle, dim=-1, keepdim=True)
    half = 0.5 * angles
    small = angles < 1e-6
    sin_half_over_angle = torch.where(
        small, 0.5 - angles * angles / 48.0, torch.sin(half) / torch.clamp(angles, min=1e-30))
    quat = torch.cat([torch.cos(half), axis_angle * sin_half_over_angle], dim=-1)
    return quaternion_to_matrix(quat)


def matrix_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> unit quaternions (..., 4) real-first,
    by Shepperd's best-conditioned candidate, in the w >= 0 hemisphere."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    qw = torch.stack([1 + m00 + m11 + m22, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1 - m00 - m11 + m22], dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)
    scores = torch.stack(
        [1 + m00 + m11 + m22, 1 + m00 - m11 - m22, 1 - m00 + m11 - m22, 1 - m00 - m11 + m22],
        dim=-1,
    )
    best = torch.argmax(scores, dim=-1)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def matrix_to_axis_angle(R: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> axis-angle (..., 3), |angle| <= pi."""
    q = matrix_to_quaternion(R)
    xyz = q[..., 1:]
    n = torch.linalg.norm(xyz, dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(n[..., 0], q[..., 0])
    return xyz / torch.clamp(n, min=eps) * angle[..., None]


def kabsch(A: torch.Tensor, B: torch.Tensor,
           mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Optimal rigid transform (R, t) with  B ~= A @ R.T + t.

    A, B: (..., N, 3) point clouds; mask: optional (..., N) validity.
    Returns R (..., 3, 3) proper rotation and t (..., 3).
    """
    w = torch.ones(A.shape[:-1], dtype=A.dtype, device=A.device) if mask is None \
        else mask.to(A.dtype)
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1.0)
    cA = torch.sum(A * w[..., None], dim=-2) / wsum
    cB = torch.sum(B * w[..., None], dim=-2) / wsum
    Am = (A - cA[..., None, :]) * w[..., None]
    Bm = B - cB[..., None, :]
    H = torch.einsum("...ni,...nj->...ij", Am, Bm)

    Sxx, Sxy, Sxz = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    Syx, Syy, Syz = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    Szx, Szy, Szz = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    K = torch.stack(
        [
            torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], dim=-1),
            torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], dim=-1),
            torch.stack([Szx - Sxz, Sxy + Syx, Syy - Sxx - Szz, Syz + Szy], dim=-1),
            torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, Szz - Sxx - Syy], dim=-1),
        ],
        dim=-2,
    )
    _, vecs = torch.linalg.eigh(K)
    R = quaternion_to_matrix(vecs[..., -1])  # eigenvector of the largest eigenvalue
    t = cB - torch.einsum("...ij,...j->...i", R, cA)
    return R, t


def angle_between(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Numerically stable angle between vectors along the last axis."""
    a_norm = torch.linalg.norm(a, dim=-1, keepdim=True)
    b_norm = torch.linalg.norm(b, dim=-1, keepdim=True)
    num = torch.linalg.norm(a * b_norm - a_norm * b, dim=-1)
    den = torch.linalg.norm(a * b_norm + a_norm * b, dim=-1)
    return 2.0 * torch.atan2(num, torch.clamp(den, min=eps))

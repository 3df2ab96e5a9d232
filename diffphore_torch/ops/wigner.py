"""Wigner-3j coupling tensors in the real spherical-harmonic basis, computed
exactly on the host with numpy (Racah's formula, then a change of basis).

Conventions match :mod:`diffphore_torch.ops.sh`: real harmonics ordered
m = -l..l, each tensor ``C[l1, l2, l3]`` of shape (2l1+1, 2l2+1, 2l3+1)
normalized to unit Frobenius norm with its first nonzero entry positive.
"""

from __future__ import annotations

import functools
import math

import numpy as np


@functools.lru_cache(maxsize=None)
def _clebsch_gordan_complex(l1: int, l2: int, l3: int) -> np.ndarray:
    """Complex-basis Clebsch-Gordan coefficients <l1 m1 l2 m2 | l3 m3>,
    indexed by (m1+l1, m2+l2, m3+l3)."""
    f = math.factorial
    C = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    if l3 < abs(l1 - l2) or l3 > l1 + l2:
        return C
    pref_l = math.sqrt(
        (2 * l3 + 1)
        * f(l3 + l1 - l2) * f(l3 - l1 + l2) * f(l1 + l2 - l3)
        / f(l1 + l2 + l3 + 1)
    )
    for m1 in range(-l1, l1 + 1):
        for m2 in range(-l2, l2 + 1):
            m3 = m1 + m2
            if abs(m3) > l3:
                continue
            pref_m = math.sqrt(
                f(l3 + m3) * f(l3 - m3)
                * f(l1 - m1) * f(l1 + m1) * f(l2 - m2) * f(l2 + m2)
            )
            s = 0.0
            for k in range(0, l1 + l2 - l3 + 1):
                d1 = l1 + l2 - l3 - k
                d2 = l1 - m1 - k
                d3 = l2 + m2 - k
                d4 = l3 - l2 + m1 + k
                d5 = l3 - l1 - m2 + k
                if min(d1, d2, d3, d4, d5) < 0:
                    continue
                s += (-1.0) ** k / (f(k) * f(d1) * f(d2) * f(d3) * f(d4) * f(d5))
            C[m1 + l1, m2 + l2, m3 + l3] = pref_l * pref_m * s
    return C


@functools.lru_cache(maxsize=None)
def _real_to_complex(l: int) -> np.ndarray:
    """Unitary U with  Y^complex_m = sum_m' U[m, m'] Y^real_m'."""
    n = 2 * l + 1
    U = np.zeros((n, n), dtype=np.complex128)
    for m in range(-l, l + 1):
        i = m + l
        if m == 0:
            U[i, l] = 1.0
        elif m > 0:
            U[i, m + l] = (-1) ** m / math.sqrt(2)
            U[i, -m + l] = 1j * (-1) ** m / math.sqrt(2)
        else:
            U[i, -m + l] = 1 / math.sqrt(2)
            U[i, m + l] = -1j / math.sqrt(2)
    return U


@functools.lru_cache(maxsize=None)
def wigner_3j(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis invariant coupling tensor (float64), all-zero when the
    triangle inequality fails."""
    cg = _clebsch_gordan_complex(l1, l2, l3)
    if not cg.any():
        return np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    U1 = _real_to_complex(l1)
    U2 = _real_to_complex(l2)
    U3 = _real_to_complex(l3)
    R = np.einsum("ma,nb,pc,mnp->abc", U1, U2, np.conj(U3), cg.astype(np.complex128))
    re, im = np.real(R), np.imag(R)
    # the invariant subspace is one-dimensional and lands in either the real
    # or the imaginary part, depending on the parities
    tensor = re if np.abs(re).max() >= np.abs(im).max() else im
    if np.abs(tensor).max() <= 1e-12:
        raise ValueError(f"degenerate coupling tensor for {(l1, l2, l3)}")
    tensor = tensor / np.linalg.norm(tensor)
    flat = tensor.ravel()
    first = flat[np.abs(flat) > 1e-12][0]
    if first < 0:
        tensor = -tensor
    return np.ascontiguousarray(tensor)

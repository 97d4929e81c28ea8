"""Small batched linear algebra: 3x3 adjugate solve/inverse and an unrolled
Gauss-Jordan inverse, with the semantics of vista_slam_tpu/ops/linalg.py
(a singular input gives inf/NaN, no pivoting in Gauss-Jordan)."""

from __future__ import annotations

import torch


def _cofactors(A: torch.Tensor):
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    # adj[i, j] = cofactor(j, i)
    c00 = a11 * a22 - a12 * a21
    c01 = a02 * a21 - a01 * a22
    c02 = a01 * a12 - a02 * a11
    c10 = a12 * a20 - a10 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a02 * a10 - a00 * a12
    c20 = a10 * a21 - a11 * a20
    c21 = a01 * a20 - a00 * a21
    c22 = a00 * a11 - a01 * a10
    det = a00 * c00 + a01 * c10 + a02 * c20
    return (c00, c01, c02, c10, c11, c12, c20, c21, c22), det


def cramer_solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for [..., 3, 3], [..., 3] by the adjugate."""
    (c00, c01, c02, c10, c11, c12, c20, c21, c22), det = _cofactors(A)
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([(c00 * b0 + c01 * b1 + c02 * b2) / det,
                        (c10 * b0 + c11 * b1 + c12 * b2) / det,
                        (c20 * b0 + c21 * b1 + c22 * b2) / det], dim=-1)


def adjugate_inv3(A: torch.Tensor) -> torch.Tensor:
    """Inverse of [..., 3, 3] matrices by the adjugate."""
    (c00, c01, c02, c10, c11, c12, c20, c21, c22), det = _cofactors(A)
    adj = torch.stack([torch.stack([c00, c01, c02], dim=-1),
                       torch.stack([c10, c11, c12], dim=-1),
                       torch.stack([c20, c21, c22], dim=-1)], dim=-2)
    return adj / det[..., None, None]


def gauss_jordan_inv(B: torch.Tensor, pivot_floor: float = 1e-30) -> torch.Tensor:
    """Inverse of small SPD-like [..., d, d] matrices by Gauss-Jordan
    elimination without pivoting; a pivot below ``pivot_floor`` divides by
    1.0 instead, giving finite garbage rather than inf/NaN."""
    d = B.shape[-1]
    eye = torch.eye(d, dtype=B.dtype, device=B.device).expand(B.shape)
    aug = torch.cat([B, eye], dim=-1)
    for k in range(d):
        piv = aug[..., k, k]
        piv = torch.where(piv.abs() > pivot_floor, piv, torch.ones_like(piv))
        row = aug[..., k, :] / piv[..., None]
        aug = aug - aug[..., :, k, None] * row[..., None, :]
        aug = torch.cat([aug[..., :k, :], row[..., None, :], aug[..., k + 1:, :]],
                        dim=-2)
    return aug[..., :, d:]

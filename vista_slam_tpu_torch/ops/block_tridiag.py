"""Block-tridiagonal SPD solver by cyclic reduction, the PGO chain
preconditioner, as in vista_slam_tpu/ops/block_tridiag.py.

The pose-graph Hessian of a long keyframe chain is dominated by the
odometry edges between consecutive nodes. Solving the block-TRIDIAGONAL
part of H exactly in every CG iteration carries a correction along the
whole chain at once, so CG is left with the loop-closure couplings only.

Cyclic reduction restructures the block-Thomas recurrence into
ceil(log2 M) levels, each a batched [M, d, d] product and inverse over the
whole node buffer: no sequential dependency longer than the level count.
For SPD input every reduced system is again SPD (Schur complements), so no
pivoting is needed. Rows passed as B = I, C = 0 (padding, fixed nodes) are
exact identity equations and decouple.

The batched d x d inverse is ``spd_inv``, ``torch.linalg.inv_ex``: at
[4800, 7, 7] on an H100 it took 0.0645 ms a call against 0.2106 ms for
``cholesky_ex`` + ``cholesky_inverse`` (whose batched path syncs with the
host) and 0.6400 ms for the Gauss-Jordan inverse of ops/linalg.py (42
launches), with the same error (chip_smoke.py phase 14d; PERF.md). A
level's rows that are not active hold stale blocks that may be singular;
their inverses are never read by an active row, so whatever they hold
stays in those rows.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def spd_inv(B: torch.Tensor) -> torch.Tensor:
    """Batched inverse of SPD [..., d, d] blocks (no host sync: a singular
    block gives inf or NaN, it does not raise)."""
    return torch.linalg.inv_ex(B)[0]


def _shift_down(x: torch.Tensor, s: int) -> torch.Tensor:
    """y[i] = x[i - s], zero for i < s."""
    return F.pad(x[:-s], (0, 0) * (x.dim() - 1) + (s, 0))


def _shift_up(x: torch.Tensor, s: int) -> torch.Tensor:
    """y[i] = x[i + s], zero for i >= M - s."""
    return F.pad(x[s:], (0, 0) * (x.dim() - 1) + (0, s))


def factor_block_tridiag(B: torch.Tensor, C: torch.Tensor):
    """Cyclic-reduction factorisation of the SPD block-tridiagonal matrix
    with diagonal blocks ``B[i]`` ([M, d, d]) and super-diagonal blocks
    ``C[i]`` coupling rows i and i + 1 ([M, d, d]; ``C[M-1]`` must be
    zero). The sub-diagonal is ``C[i]^T`` (assumed, not checked).

    Returns an opaque factorisation for `solve_block_tridiag`. Cost:
    ceil(log2 M) levels of batched d x d products and one batched inverse
    each."""
    M = B.shape[0]
    A = _shift_down(C, 1).transpose(1, 2)
    levels = []
    s = 1
    while s < M:
        Binv = spd_inv(B)
        # rows beyond the ends read an identity block (the JAX fill); it
        # only ever multiplies a zero coupling
        eye = torch.eye(B.shape[1], dtype=B.dtype, device=B.device)
        Binv_dn = torch.cat([eye.expand(s, -1, -1), Binv[:-s]])
        Binv_up = torch.cat([Binv[s:], eye.expand(s, -1, -1)])
        P = A @ Binv_dn  # A_i B_{i-s}^-1
        Q = C @ Binv_up  # C_i B_{i+s}^-1
        levels.append((Binv, A, C, P, Q))
        # Schur complement onto rows i = 0 mod 2s, eliminating i +- s; all
        # rows are computed, the inactive ones are never read again
        B = B - P @ _shift_down(C, s) - Q @ _shift_up(A, s)
        A, C = -(P @ _shift_down(A, s)), -(Q @ _shift_up(C, s))
        s *= 2
    return M, tuple(levels), spd_inv(B)  # only row 0 of the root is read


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (m @ v[..., None])[..., 0]


def solve_block_tridiag(fac, r: torch.Tensor) -> torch.Tensor:
    """Solve T x = r ([M, d]) for a factorisation from
    `factor_block_tridiag`; identity rows return their rhs."""
    M, levels, root_inv = fac
    idx = torch.arange(M, device=r.device)[:, None]
    rs = []
    s = 1
    for (_, _, _, P, Q) in levels:  # fold eliminated rows into kept rows
        rs.append(r)
        r = r - _mv(P, _shift_down(r, s)) - _mv(Q, _shift_up(r, s))
        s *= 2
    x = torch.where(idx == 0, _mv(root_inv, r), torch.zeros_like(r))
    for lvl in range(len(levels) - 1, -1, -1):  # back-substitute, finest last
        s = 1 << lvl
        Binv, A, C, _, _ = levels[lvl]
        rhs = rs[lvl] - _mv(A, _shift_down(x, s)) - _mv(C, _shift_up(x, s))
        x = torch.where(idx % (2 * s) == s, _mv(Binv, rhs), x)
    return x

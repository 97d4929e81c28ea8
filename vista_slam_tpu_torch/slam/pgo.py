"""Windowed Sim(3) pose-graph optimisation (Levenberg-Marquardt), dense
solver, as in vista_slam_tpu/slam/pgo.py.

  * Per-edge residuals r_e = Log(Z_e * X_i^-1 * X_j) and their two 7x7
    tangent-space Jacobians by forward-mode autodiff (torch.func.jacfwd
    under vmap).
  * The optimisation window (nodes allowed to move) is gathered and the
    damped normal equations are assembled densely, equilibrated by the
    analytic diagonal, and solved by Cholesky — the reference's solver
    shape (pypose LM + Cholesky, reference: vista_slam/slam.py:43,123-137).
  * LM with damping and trust-radius adaptation and the plateau exit of
    pypose's StopOnPlateau(steps=20, patience=3, decreasing=1e-4)
    (slam.py:125-127), as a host loop over device steps.
Only edges with at least one windowed endpoint contribute; everything
outside the window is frozen (reference: pose_graph.py:104-154).

The JAX package's matrix-free PCG solver (and its block-tridiagonal
preconditioner) is not ported yet; see ROADMAP.md.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..ops import sim3


class PGOConfig(NamedTuple):
    max_steps: int = 20
    patience: int = 3
    rel_decrease: float = 1e-4
    lambda0: float = 1e-4
    lambda_min: float = 1e-8
    lambda_max: float = 1e6
    lambda_up: float = 4.0
    lambda_down: float = 0.5
    # "dense" or "auto" (dense up to dense_max optimised nodes). "pcg" and
    # windows past dense_max raise NotImplementedError.
    solver: str = "auto"
    dense_max: int = 1024
    # adaptive per-node tangent-space trust region (pypose TrustRegion
    # semantics, reference: slam.py:125 with radius=1e4)
    radius0: float = 1e4
    radius_up: float = 2.0
    radius_down: float = 0.25
    radius_min: float = 1e-3
    radius_max: float = 1e6


def _edge_residual(xi_i, xi_j, node_i, node_j, edge_pose):
    """r(d_i, d_j) = Log(Z * (X_i Exp(d_i))^-1 * (X_j Exp(d_j)))."""
    gi = sim3.mul(node_i, sim3.exp(xi_i))
    gj = sim3.mul(node_j, sim3.exp(xi_j))
    return sim3.log(sim3.mul(sim3.mul(edge_pose, sim3.inv(gi)), gj))


def _residuals_and_jacobians(nodes, edges, edge_poses):
    """Residuals [E,7] and Jacobians Ji, Jj [E,7,7] at delta = 0."""
    zero = torch.zeros(7, dtype=nodes.dtype, device=nodes.device)

    def per_edge(n_i, n_j, z):
        r = _edge_residual(zero, zero, n_i, n_j, z)
        Ji = jacfwd(lambda d: _edge_residual(d, zero, n_i, n_j, z))(zero)
        Jj = jacfwd(lambda d: _edge_residual(zero, d, n_i, n_j, z))(zero)
        return r, Ji, Jj

    return vmap(per_edge)(nodes[edges[:, 0]], nodes[edges[:, 1]], edge_poses)


def _loss(nodes, edges, edge_poses, w) -> torch.Tensor:
    r = sim3.log(sim3.mul(sim3.mul(edge_poses, sim3.inv(nodes[edges[:, 0]])),
                          nodes[edges[:, 1]]))
    return (w * r * r).sum()


def _block_rows_cols(c: torch.Tensor):
    a7 = torch.arange(7, device=c.device)
    return c[:, None, None] * 7 + a7[None, :, None], c[:, None, None] * 7 + a7[None, None, :]


def optimize_pose_graph(nodes, edges, edge_poses, edge_confs, edge_valid,
                        opt_mask, cfg: PGOConfig = PGOConfig()):
    """Windowed LM-PGO.

    nodes [N, 8] Sim(3), edges [E, 2] node indices, edge_poses [E, 8],
    edge_confs [E, 7] per-tangent-dim weights, edge_valid [E] bool,
    opt_mask [N] bool (nodes allowed to move); all tensors on one device.
    Returns (new nodes [N, 8], info {loss0, loss, steps, lambda}).
    """
    k = int(opt_mask.sum())
    solver = cfg.solver
    if solver == "auto":
        solver = "dense" if k <= cfg.dense_max else "pcg"
    if solver != "dense":
        raise NotImplementedError(
            f"PGO solver {solver!r} ({k} optimised nodes): only the dense "
            "solver is ported; PCG with the block-tridiagonal preconditioner "
            "is queued in ROADMAP.md")
    f32 = torch.float32
    dev = nodes.device
    N = nodes.shape[0]
    nodes = nodes.to(f32)
    edges = edges.long()
    opt_mask = opt_mask.bool()

    # edges outside the window carry zero weight: drop them up front
    keep = edge_valid.bool() & (opt_mask[edges[:, 0]] | opt_mask[edges[:, 1]])
    edges, edge_poses = edges[keep], edge_poses[keep].to(f32)
    w = edge_confs[keep].to(f32)
    if k == 0 or edges.shape[0] == 0:  # nothing can move
        loss0 = float(_loss(nodes, edges, edge_poses, w).item())
        return nodes, {"loss0": loss0, "loss": loss0, "steps": 0,
                       "lambda": cfg.lambda0}
    ei, ej = edges[:, 0], edges[:, 1]
    mi = opt_mask[ei].to(f32)[:, None]
    mj = opt_mask[ej].to(f32)[:, None]
    opt = opt_mask.to(f32)[:, None]

    opt_idx = torch.nonzero(opt_mask).flatten()  # ascending, like jnp.nonzero
    col_of = torch.full((N,), k, dtype=torch.long, device=dev)
    col_of[opt_idx] = torch.arange(k, device=dev)
    ci, cj = col_of[ei], col_of[ej]  # k = outside the window
    D = 7 * k

    def linearize(x):
        r, Ji, Jj = _residuals_and_jacobians(x, edges, edge_poses)
        Ji = Ji * mi[..., None]  # fixed endpoints do not move
        Jj = Jj * mj[..., None]
        wr = w * r
        g = torch.zeros((N, 7), dtype=f32, device=dev)
        g.index_add_(0, ei, torch.einsum("erc,er->ec", Ji, wr))
        g.index_add_(0, ej, torch.einsum("erc,er->ec", Jj, wr))
        diag = torch.zeros((N, 7), dtype=f32, device=dev)
        diag.index_add_(0, ei, torch.einsum("er,erc->ec", w, Ji * Ji))
        diag.index_add_(0, ej, torch.einsum("er,erc->ec", w, Jj * Jj))
        return Ji, Jj, g * opt, diag

    def dense_solve(lin, lam):
        Ji, Jj, g, diag = lin
        Bii = torch.einsum("era,er,erb->eab", Ji, w, Ji)
        Bjj = torch.einsum("era,er,erb->eab", Jj, w, Jj)
        Bij = torch.einsum("era,er,erb->eab", Ji, w, Jj)
        damp_k = lam * diag[opt_idx] + 1e-10
        # equilibration by the known diagonal (undamped diag + damping)
        s2d = torch.rsqrt(torch.clamp_min(diag[opt_idx] + damp_k, 1e-30))
        s_pad = torch.cat([s2d, torch.ones((1, 7), dtype=f32, device=dev)])
        si, sj = s_pad[ci], s_pad[cj]
        # one scratch block row/column (index k) takes every out-of-window
        # endpoint and is cut off after assembly
        Hs = torch.zeros((D + 7, D + 7), dtype=f32, device=dev)
        (ri, ki), (rj, kj) = _block_rows_cols(ci), _block_rows_cols(cj)
        Hs.index_put_((ri, ki), Bii * si[:, :, None] * si[:, None, :], accumulate=True)
        Hs.index_put_((rj, kj), Bjj * sj[:, :, None] * sj[:, None, :], accumulate=True)
        Bij_s = Bij * si[:, :, None] * sj[:, None, :]
        Hs.index_put_((ri, kj), Bij_s, accumulate=True)
        Hs.index_put_((rj, ki), Bij_s.transpose(1, 2), accumulate=True)
        Hs = Hs[:D, :D]
        Hs.diagonal().add_((damp_k * s2d * s2d).reshape(-1))
        bs = -g[opt_idx].reshape(-1) * s2d.reshape(-1)
        L, info = torch.linalg.cholesky_ex(Hs)
        y = torch.cholesky_solve(bs[:, None], L)[:, 0]
        delta_k = y.reshape(k, 7) * s2d
        # a non-PD system gives no step (the LM loop then rejects and damps)
        delta_k = torch.where(info == 0, delta_k, torch.zeros_like(delta_k))
        delta = torch.zeros((N, 7), dtype=f32, device=dev)
        delta[opt_idx] = delta_k
        return delta

    def cap_step(delta, radius):
        norm = torch.linalg.vector_norm(delta, dim=-1, keepdim=True)
        capped = delta * torch.clamp(radius / torch.clamp_min(norm, 1e-12), max=1.0)
        return torch.where(torch.isfinite(capped), capped, torch.zeros_like(capped))

    f = np.float32
    loss0 = f(_loss(nodes, edges, edge_poses, w).item())
    x, lin = nodes, linearize(nodes)
    lam, radius, best = f(cfg.lambda0), f(cfg.radius0), loss0
    plateau = steps = 0
    while steps < cfg.max_steps:
        delta = cap_step(dense_solve(lin, float(lam)), float(radius))
        x_new = sim3.normalize(sim3.retract(x, delta * opt))
        new_loss = f(_loss(x_new, edges, edge_poses, w).item())
        if not np.isfinite(new_loss):
            new_loss = f(np.inf)
        accept = bool(new_loss < best)
        if accept:  # re-linearise only where x moved
            x, lin = x_new, linearize(x_new)
            lam = max(lam * f(cfg.lambda_down), f(cfg.lambda_min))
            radius = min(radius * f(cfg.radius_up), f(cfg.radius_max))
        else:
            lam = min(lam * f(cfg.lambda_up), f(cfg.lambda_max))
            radius = max(radius * f(cfg.radius_down), f(cfg.radius_min))
        # plateau counts accepted steps without meaningful relative decrease
        rel = (best - new_loss) / max(best, f(1e-12))
        if accept:
            plateau = 0 if rel >= f(cfg.rel_decrease) else plateau + 1
        best = min(best, new_loss)
        steps += 1
        if plateau >= cfg.patience:
            break
    return x, {"loss0": float(loss0), "loss": float(best), "steps": steps,
               "lambda": float(lam)}

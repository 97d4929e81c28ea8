"""Windowed Sim(3) pose-graph optimisation (Levenberg-Marquardt), as in
vista_slam_tpu/slam/pgo.py.

  * Per-edge residuals r_e = Log(Z_e * X_i^-1 * X_j) and their two 7x7
    tangent-space Jacobians by forward-mode autodiff (torch.func.jacfwd
    under vmap).
  * Two linear solvers for (J^T W J + lambda D) delta = -J^T W r, chosen per
    call (PGOConfig.solver):
      - "dense" gathers the optimisation window, assembles the damped normal
        equations densely, equilibrated by the analytic diagonal, and solves
        by Cholesky: the reference's solver shape (pypose LM + Cholesky,
        reference: vista_slam/slam.py:43,123-137);
      - "pcg" is matrix-free preconditioned CG over the whole node buffer,
        O(E + N) memory, preconditioned by an exact solve of the
        block-TRIDIAGONAL part of H in buffer node order (the odometry
        chain; ops/block_tridiag.py) or by its 7x7 diagonal blocks;
      - "auto" takes dense up to dense_max optimised nodes and pcg beyond.
  * LM with damping and trust-radius adaptation and the plateau exit of
    pypose's StopOnPlateau(steps=20, patience=3, decreasing=1e-4)
    (slam.py:125-127), as a host loop over device steps; the linearisation
    is redone only when a step is accepted.
  * Sums over edges into nodes gather in a fixed order (``_node_sum``), so
    a solve repeats bit for bit on CUDA.
Only edges with at least one windowed endpoint contribute; everything
outside the window is frozen (reference: pose_graph.py:104-154).

``CALLS`` counts the solves by the route they took.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..ops import sim3
from ..ops.block_tridiag import factor_block_tridiag, solve_block_tridiag, spd_inv

CALLS = {"dense": 0, "pcg": 0}  # solves by route (optimize_pose_graph calls)
CG_CHECK_EVERY = 8  # CG iterations between host reads of the stop test


class PGOConfig(NamedTuple):
    max_steps: int = 20
    patience: int = 3
    rel_decrease: float = 1e-4
    lambda0: float = 1e-4
    lambda_min: float = 1e-8
    lambda_max: float = 1e6
    lambda_up: float = 4.0
    lambda_down: float = 0.5
    # "dense", "pcg" or "auto": dense up to dense_max optimised nodes, pcg
    # beyond. On an H100 the dense solve was faster at every window of
    # the production buffers (4800 nodes / 5200 edges): 3.2-3.5 / 3.6-4.5 /
    # 6.3-6.6 / 10.8-11.7 s against PCG's 7.8-9.6 / 13.2-14.3 / 16.6-18.0 /
    # 15.4-17.5 s per 20-step solve at 512 / 1024 / 2048 / 4790 optimised
    # nodes (chip_smoke.py phase 14d, two runs; PERF.md). So auto stays dense up to the buffers' 4800
    # nodes (a 4.5 GB system); pcg is chosen by name (configs/live.yaml)
    # or past that size.
    solver: str = "auto"
    dense_max: int = 4800
    # PCG: iteration cap, relative tolerance ||r|| <= cg_tol (1 + ||b||),
    # and the preconditioner: "tridiag" (exact solve of the block-
    # tridiagonal part of H in buffer node order) or "jacobi" (its 7x7
    # diagonal blocks)
    cg_iters: int = 128
    cg_tol: float = 1e-6
    pcg_precond: str = "tridiag"
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


def _mv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector products [..., a, b] x [..., b] -> [..., a]."""
    return (m @ v[..., None])[..., 0]


def _mtv(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched m^T v: [..., a, b] x [..., a] -> [..., b]."""
    return (v[..., None, :] @ m)[..., 0, :]


def _node_sum(ei: torch.Tensor, ej: torch.Tensor, N: int):
    """node_sum(ci, cj): the per-edge contributions ci (to node ei) and cj
    (to node ej), [E, ...] each, summed into [N, ...]. Each node gathers its
    incident edges' contributions (i sides, then j sides, in edge order) and
    adds them in that order, so two solves of one graph give the same bits
    on CUDA, where index_add_ adds in the order its atomics land."""
    dest = torch.cat([ei, ej])
    n = dest.shape[0]
    order = torch.argsort(dest, stable=True)
    counts = torch.bincount(dest, minlength=N)
    first = torch.cumsum(counts, 0) - counts
    rank = torch.arange(n, device=dest.device) - first[dest[order]]
    idx = torch.full((N, int(counts.max())), n, dtype=torch.long, device=dest.device)
    idx[dest[order], rank] = order  # n: a zero row, for nodes of lower degree

    def node_sum(ci: torch.Tensor, cj: torch.Tensor) -> torch.Tensor:
        return torch.cat([ci, cj, ci.new_zeros((1,) + ci.shape[1:])])[idx].sum(1)

    return node_sum


def optimize_pose_graph(nodes, edges, edge_poses, edge_confs, edge_valid,
                        opt_mask, cfg: PGOConfig = PGOConfig()):
    """Windowed LM-PGO.

    nodes [N, 8] Sim(3), edges [E, 2] node indices, edge_poses [E, 8],
    edge_confs [E, 7] per-tangent-dim weights, edge_valid [E] bool,
    opt_mask [N] bool (nodes allowed to move); all tensors on one device.
    Returns (new nodes [N, 8], info {loss0, loss, steps, lambda, solver,
    cg_iters}); cg_iters lists the CG iterations of each LM step (pcg).
    """
    k = int(opt_mask.sum())
    solver = cfg.solver
    if solver == "auto":
        solver = "dense" if k <= cfg.dense_max else "pcg"
    if solver not in CALLS:
        raise ValueError(f"unknown PGO solver {solver!r}")
    CALLS[solver] += 1
    f32 = torch.float32
    dev = nodes.device
    N = nodes.shape[0]
    nodes = nodes.to(f32)
    edges = edges.long()
    opt_mask = opt_mask.bool()

    # edges outside the window carry zero weight: drop them up front (node
    # indices stay those of the buffer)
    keep = edge_valid.bool() & (opt_mask[edges[:, 0]] | opt_mask[edges[:, 1]])
    edges, edge_poses = edges[keep], edge_poses[keep].to(f32)
    w = edge_confs[keep].to(f32)
    if k == 0 or edges.shape[0] == 0:  # nothing can move
        loss0 = float(_loss(nodes, edges, edge_poses, w).item())
        return nodes, {"loss0": loss0, "loss": loss0, "steps": 0,
                       "lambda": cfg.lambda0, "solver": solver, "cg_iters": []}
    ei, ej = edges[:, 0], edges[:, 1]
    mi = opt_mask[ei].to(f32)[:, None]
    mj = opt_mask[ej].to(f32)[:, None]
    opt = opt_mask.to(f32)[:, None]
    node_sum = _node_sum(ei, ej, N)

    def linearize(x):
        r, Ji, Jj = _residuals_and_jacobians(x, edges, edge_poses)
        Ji = Ji * mi[..., None]  # fixed endpoints do not move
        Jj = Jj * mj[..., None]
        wr = w * r
        g = node_sum(torch.einsum("erc,er->ec", Ji, wr), torch.einsum("erc,er->ec", Jj, wr))
        diag = node_sum(torch.einsum("er,erc->ec", w, Ji * Ji),
                        torch.einsum("er,erc->ec", w, Jj * Jj))
        return Ji, Jj, g * opt, diag

    if solver == "dense":
        solve = _dense_solver(N, k, opt_mask, ei, ej, w, dev)
    else:
        solve = _pcg_solver(opt_mask, ei, ej, w, cfg, node_sum)
    cg_counts: list = []

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
        delta = cap_step(solve(lin, float(lam), cg_counts), float(radius))
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
               "lambda": float(lam), "solver": solver,
               "cg_iters": [int(c) for c in cg_counts]}


def _dense_solver(N, k, opt_mask, ei, ej, w, dev):
    """The damped, equilibrated normal equations of the k optimised nodes,
    assembled densely and solved by Cholesky; returns solve(lin, lam, _)."""
    f32 = torch.float32
    opt_idx = torch.nonzero(opt_mask).flatten()  # ascending, like jnp.nonzero
    col_of = torch.full((N,), k, dtype=torch.long, device=dev)
    col_of[opt_idx] = torch.arange(k, device=dev)
    ci, cj = col_of[ei], col_of[ej]  # k = outside the window
    D = 7 * k

    def solve(lin, lam, _counts):
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

    return solve


def _pcg_solver(opt_mask, ei, ej, w, cfg: PGOConfig, node_sum):
    """Matrix-free PCG over the whole node buffer (the JAX package's
    pcg_solve); returns solve(lin, lam, counts), which appends the
    iteration count of each call to ``counts`` (a device tensor)."""
    f32 = torch.float32
    dev = w.device
    opt = opt_mask.to(f32)[:, None]
    eye = torch.eye(7, dtype=f32, device=dev)
    # the band: edges between consecutive buffer indices
    fwd = (ej == ei + 1).to(f32)[:, None, None]
    bwd = (ei == ej + 1).to(f32)[:, None, None]

    def Hv(lin, damp, v):  # (J^T W J + lam D) v on the optimised nodes
        Ji, Jj = lin[0], lin[1]
        v = v * opt
        wJv = w * (_mv(Ji, v[ei]) + _mv(Jj, v[ej]))
        return (node_sum(_mtv(Ji, wJv), _mtv(Jj, wJv)) + damp * v) * opt

    def preconditioner(lin, damp):
        Ji, Jj = lin[0], lin[1]
        blocks = node_sum(torch.einsum("era,er,erb->eab", Ji, w, Ji),
                          torch.einsum("era,er,erb->eab", Jj, w, Jj))
        blocks = blocks + torch.diag_embed(damp) + eye * 1e-8
        if cfg.pcg_precond == "jacobi":
            blocks_inv = spd_inv(blocks)
            return lambda v: _mv(blocks_inv, v) * opt
        if cfg.pcg_precond != "tridiag":
            raise ValueError(f"unknown pcg_precond {cfg.pcg_precond!r}")
        # every chain edge's full PSD block lands in the band; other edges
        # keep their diagonal blocks only, so the band stays SPD. Fixed and
        # padding rows are identity equations (their Jacobians are masked).
        Bij = torch.einsum("era,er,erb->eab", Ji, w, Jj)
        Csup = node_sum(Bij * fwd, Bij.transpose(1, 2) * bwd)
        fac = factor_block_tridiag(
            torch.where(opt_mask[:, None, None], blocks, eye), Csup)
        return lambda v: solve_block_tridiag(fac, v) * opt

    def solve(lin, lam, counts):
        g, diag = lin[2], lin[3]
        damp = lam * diag + 1e-10
        precond = preconditioner(lin, damp)
        b = -g
        thresh = cfg.cg_tol * (1.0 + torch.linalg.vector_norm(b))
        x, r, p = torch.zeros_like(b), b, precond(b)
        rz = (b * p).sum()
        done = torch.zeros((), dtype=torch.long, device=dev)
        # the while loop of the JAX solver, tested on the host every
        # CG_CHECK_EVERY iterations: an iteration past the stop test leaves
        # the state as it was, so the result is the while loop's
        for it in range(cfg.cg_iters):
            active = torch.linalg.vector_norm(r) > thresh
            if it % CG_CHECK_EVERY == 0 and not bool(active):
                break
            Hp = Hv(lin, damp, p)
            pHp = (p * Hp).sum()
            # no step along (numerically) non-positive curvature
            alpha = torch.where(pHp > 1e-20, rz / torch.clamp_min(pHp, 1e-20),
                                torch.zeros_like(pHp))
            x_n = x + alpha * p
            r_n = r - alpha * Hp
            z_n = precond(r_n)
            rz_n = (r_n * z_n).sum()
            p_n = z_n + rz_n / torch.clamp_min(rz, 1e-20) * p
            x, r, p, rz = (torch.where(active, n, o) for n, o in
                           ((x_n, x), (r_n, r), (p_n, p), (rz_n, rz)))
            done = done + active
        counts.append(done)
        return x

    return solve

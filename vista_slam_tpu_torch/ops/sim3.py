"""Sim(3) Lie group operations on torch tensors.

Same layouts and numerics as vista_slam_tpu/ops/sim3.py:
  group element g[..., 8]  = (tx, ty, tz, qx, qy, qz, qw, s)
  tangent      xi[..., 7]  = (tau_x, tau_y, tau_z, phi_x, phi_y, phi_z, sigma)
All functions work on the trailing axis, broadcast over leading axes, and
are safe under ``torch.func.jacfwd``/``vmap``: every division and branch at
the small-angle / zero-scale singularities is guarded on both sides of its
``torch.where``. Per-element scalars (angle, scale, sigma) are kept as
[..., 1] slices: under vmap a 0-dim tensor combined with a Python float gets
float64 forward-mode tangents.
"""

from __future__ import annotations

import math

import torch

from .linalg import cramer_solve3

_EPS = 1e-8
_SMALL = 1e-6  # switch point to Taylor expansions


# -- quaternions (x, y, z, w) -------------------------------------------------

def quat_identity(shape=(), dtype=torch.float32, device="cpu") -> torch.Tensor:
    q = torch.zeros(tuple(shape) + (4,), dtype=dtype, device=device)
    q[..., 3] = 1.0
    return q


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack([aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw,
                        aw * bw - ax * bx - ay * by - az * bz], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp_min(n, _EPS)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v[..., 3] by unit quaternions q[..., 4]."""
    u = q[..., :3].expand(v.shape) if q.dim() < v.dim() else q[..., :3]
    w = q[..., 3:4]
    uv = torch.linalg.cross(u, v, dim=-1)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv, dim=-1))


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
                     2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
                     2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> unit quaternion (x, y, z, w), w >= 0.
    Branch-free Shepperd extraction: all four candidates are built and the
    best conditioned one is selected."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    qw2 = 1.0 + m00 + m11 + m22
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    def safe_sqrt(v):
        return torch.sqrt(torch.clamp_min(v, _EPS))

    sw = safe_sqrt(qw2) * 2.0
    cand_w = torch.stack([(m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw, sw / 4.0], -1)
    sx = safe_sqrt(qx2) * 2.0
    cand_x = torch.stack([sx / 4.0, (m01 + m10) / sx, (m02 + m20) / sx, (m21 - m12) / sx], -1)
    sy = safe_sqrt(qy2) * 2.0
    cand_y = torch.stack([(m01 + m10) / sy, sy / 4.0, (m12 + m21) / sy, (m02 - m20) / sy], -1)
    sz = safe_sqrt(qz2) * 2.0
    cand_z = torch.stack([(m02 + m20) / sz, (m12 + m21) / sz, sz / 4.0, (m10 - m01) / sz], -1)

    best = torch.stack([qx2, qy2, qz2, qw2], dim=-1).argmax(dim=-1)
    cands = torch.stack([cand_x, cand_y, cand_z, cand_w], dim=-2)  # [..., 4, 4]
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx)[..., 0, :]
    q = torch.where(q[..., 3:4] < 0, -q, q)
    return quat_normalize(q)


# -- SO(3) exp/log via quaternions -------------------------------------------

def so3_exp_quat(phi: torch.Tensor) -> torch.Tensor:
    theta2 = (phi * phi).sum(-1, keepdim=True)
    theta = torch.sqrt(torch.clamp_min(theta2, _EPS * _EPS))
    small = theta2 < _SMALL
    half = 0.5 * theta
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return torch.cat([phi * k, w], dim=-1)


def so3_log_quat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> axis-angle phi[..., 3] (angle in [0, pi])."""
    q = torch.where(q[..., 3:4] < 0, -q, q)
    v = q[..., :3]
    w = q[..., 3:4]
    vn2 = (v * v).sum(-1, keepdim=True)
    vn = torch.sqrt(torch.clamp_min(vn2, _EPS * _EPS))
    angle = 2.0 * torch.atan2(vn, w)
    small = vn2 < _SMALL * _SMALL
    w_safe = torch.clamp_min(w, _EPS)
    k = torch.where(small, 2.0 / w_safe * (1.0 - vn2 / (3.0 * w_safe * w_safe)),
                    angle / vn)
    return v * k


def hat(phi: torch.Tensor) -> torch.Tensor:
    x, y, z = phi.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


# -- Sim(3) group ops ---------------------------------------------------------

def identity(shape=(), dtype=torch.float32, device="cpu") -> torch.Tensor:
    g = torch.zeros(tuple(shape) + (8,), dtype=dtype, device=device)
    g[..., 6] = 1.0
    g[..., 7] = 1.0
    return g


def make(t: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """(t [..., 3], q [..., 4], s [...] or [..., 1]) -> g [..., 8]."""
    return torch.cat([t, q, s[..., None] if s.dim() == t.dim() - 1 else s], dim=-1)


def trans(g):
    return g[..., 0:3]


def quat(g):
    return g[..., 3:7]


def scale(g):
    """The scale as a [..., 1] slice."""
    return g[..., 7:8]


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compose (a * b)(x) = a(b(x)): R = Ra Rb, t = sa Ra tb + ta, s = sa sb."""
    t = scale(a) * quat_rotate(quat(a), trans(b)) + trans(a)
    q = quat_normalize(quat_mul(quat(a), quat(b)))
    return torch.cat([t, q, scale(a) * scale(b)], dim=-1)


def inv(g: torch.Tensor) -> torch.Tensor:
    qc = quat_conj(quat(g))
    s_inv = 1.0 / torch.clamp_min(scale(g), _EPS)
    t = -s_inv * quat_rotate(qc, trans(g))
    return torch.cat([t, qc, s_inv], dim=-1)


def act(g: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply g to points pts[..., 3]: s R x + t."""
    return scale(g) * quat_rotate(quat(g), pts) + trans(g)


def _rt_to_mat44(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    m = torch.zeros(R.shape[:-2] + (4, 4), dtype=R.dtype, device=R.device)
    m[..., :3, :3] = R
    m[..., :3, 3] = t
    m[..., 3, 3] = 1.0
    return m


def to_matrix(g: torch.Tensor) -> torch.Tensor:
    """4x4 homogeneous matrix with the scaled rotation block [sR | t]."""
    return _rt_to_mat44(quat_to_matrix(quat(g)) * scale(g)[..., None], trans(g))


def to_pose_matrix(g: torch.Tensor) -> torch.Tensor:
    """4x4 rigid pose [R | t] with the scale factored out (the reference
    exports camera poses so and scales the depth map, slam.py:304-315)."""
    return _rt_to_mat44(quat_to_matrix(quat(g)), trans(g))


def from_rt(R: torch.Tensor, t: torch.Tensor, s=1.0) -> torch.Tensor:
    q = matrix_to_quat(R)
    s = torch.as_tensor(s, dtype=t.dtype, device=t.device).expand(t.shape[:-1])
    return torch.cat([t, q, s[..., None]], dim=-1)


def from_matrix(m: torch.Tensor, s=1.0) -> torch.Tensor:
    """4x4 rigid pose matrix -> Sim(3) with explicit scale."""
    return from_rt(m[..., :3, :3], m[..., :3, 3], s)


# -- Sim(3) exp/log -------------------------------------------------------------

def _moment_series(k: int, sigma: torch.Tensor) -> torch.Tensor:
    """M_k(sigma) = int_0^1 u^k e^{sigma u} du as its Taylor series to j=5."""
    # a tensor start: a Python-float start gives float64 forward-mode tangents
    out = torch.zeros_like(sigma)
    for j in reversed(range(6)):
        out = out * sigma + 1.0 / (math.factorial(j) * (k + j + 1))
    return out


def _sim3_W_coeffs(theta2: torch.Tensor, sigma: torch.Tensor):
    """(a, b, c) of W = a I + b Omega + c Omega^2, W = int_0^1 e^{sigma u}
    R(u theta) du. Series branches for |sigma| < 0.1 and theta^2 < 0.01,
    where every closed form cancels catastrophically in fp32; closed forms
    elsewhere. Takes theta^2 (smooth at phi = 0) rather than theta."""
    sigma2 = sigma * sigma
    s = torch.exp(sigma)
    small_s = sigma.abs() < 0.1
    small_t = theta2 < 0.01
    one = torch.ones_like(sigma)
    sigma_safe = torch.where(small_s, one, sigma)
    theta = torch.sqrt(torch.where(small_t, torch.ones_like(theta2), theta2))

    a = torch.where(small_s, _moment_series(0, sigma), torch.expm1(sigma) / sigma_safe)

    s2 = sigma_safe * sigma_safe
    s3 = s2 * sigma_safe
    s4, s5 = s2 * s2, s2 * s3
    s6, s7 = s3 * s3, s3 * s4
    M1e = (s * (sigma - 1.0) + 1.0) / s2
    M2e = (s * (sigma2 - 2.0 * sigma + 2.0) - 2.0) / s3
    M3e = (s * (s3 - 3.0 * s2 + 6.0 * sigma - 6.0) + 6.0) / s4
    M4e = (s * (s4 - 4.0 * s3 + 12.0 * s2 - 24.0 * sigma + 24.0) - 24.0) / s5
    M5e = (s * (s5 - 5.0 * s4 + 20.0 * s3 - 60.0 * s2 + 120.0 * sigma - 120.0)
           + 120.0) / s6
    M6e = (s * (s6 - 6.0 * s5 + 30.0 * s4 - 120.0 * s3 + 360.0 * s2
                - 720.0 * sigma + 720.0) - 720.0) / s7

    def pick(k, exact):
        return torch.where(small_s, _moment_series(k, sigma), exact)

    M1, M2, M3 = pick(1, M1e), pick(2, M2e), pick(3, M3e)
    M4, M5, M6 = pick(4, M4e), pick(5, M5e), pick(6, M6e)

    theta4 = theta2 * theta2
    b_series = M1 - theta2 / 6.0 * M3 + theta4 / 120.0 * M5
    c_series = 0.5 * M2 - theta2 / 24.0 * M4 + theta4 / 720.0 * M6

    denom = torch.where(small_t, torch.ones_like(theta2), sigma2 + theta2)
    I_s = (s * (sigma * torch.sin(theta) - theta * torch.cos(theta)) + theta) / denom
    I_c = (s * (sigma * torch.cos(theta) + theta * torch.sin(theta)) - sigma) / denom
    b_trig = I_s / theta
    c_trig = (a - I_c) / torch.where(small_t, torch.ones_like(theta2), theta2)

    b = torch.where(small_t, b_series, b_trig)
    c = torch.where(small_t, c_series, c_trig)
    return a, b, c


def _sim3_W(phi: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """W for phi [..., 3] and sigma [..., 1]."""
    theta2 = (phi * phi).sum(-1, keepdim=True)
    a, b, c = _sim3_W_coeffs(theta2, sigma)
    Om = hat(phi)
    Om2 = Om @ Om
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return (a[..., None] * eye + b[..., None] * Om
            + c[..., None] * Om2)


def exp(xi: torch.Tensor) -> torch.Tensor:
    """sim(3) -> Sim(3); xi = (tau, phi, sigma)."""
    tau, phi, sigma = xi[..., 0:3], xi[..., 3:6], xi[..., 6:7]
    q = so3_exp_quat(phi)
    W = _sim3_W(phi, sigma)
    t = (W @ tau[..., None])[..., 0]
    return torch.cat([t, q, torch.exp(sigma)], dim=-1)


def log(g: torch.Tensor) -> torch.Tensor:
    """Sim(3) -> sim(3); the W solve is the 3x3 adjugate."""
    phi = so3_log_quat(quat(g))
    sigma = torch.log(torch.clamp_min(scale(g), _EPS))
    W = _sim3_W(phi, sigma)
    tau = cramer_solve3(W, trans(g))
    return torch.cat([tau, phi, sigma], dim=-1)


def retract(g: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Right-multiplicative retraction g * Exp(xi)."""
    return mul(g, exp(xi))


def normalize(g: torch.Tensor) -> torch.Tensor:
    return torch.cat([trans(g), quat_normalize(quat(g)), g[..., 7:8]], dim=-1)


def se3_from_matrix(m: torch.Tensor) -> torch.Tensor:
    """A pose-head 4x4 output as a Sim(3) element with scale 1."""
    return from_matrix(m, 1.0)

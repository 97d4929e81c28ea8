"""Host-side (numpy) mirrors of the Sim(3) helpers used by graph bookkeeping.

The online SLAM loop composes a handful of poses per keyframe while inserting
nodes/edges (reference: vista_slam/slam.py:191-241); doing that through the
accelerator would cost a device round-trip per pose, so the bookkeeping math
stays on host. Layout matches ops/sim3.py: (t[3], q_xyzw[4], s).
"""

from __future__ import annotations

import numpy as np


def identity(n: int | None = None) -> np.ndarray:
    g = np.zeros((8,) if n is None else (n, 8), dtype=np.float32)
    g[..., 6] = 1.0
    g[..., 7] = 1.0
    return g


def quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        axis=-1,
    )


def quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    u = q[..., :3]
    w = q[..., 3:4]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    m = np.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        axis=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(m: np.ndarray) -> np.ndarray:
    """3x3 rotation -> quaternion (x, y, z, w); single matrix only."""
    t = np.trace(m)
    if t > 0:
        r = np.sqrt(1.0 + t)
        s = 0.5 / r
        q = np.array([(m[2, 1] - m[1, 2]) * s, (m[0, 2] - m[2, 0]) * s,
                      (m[1, 0] - m[0, 1]) * s, 0.5 * r])
    else:
        i = int(np.argmax(np.diag(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        r = np.sqrt(max(1.0 + m[i, i] - m[j, j] - m[k, k], 1e-12))
        s = 0.5 / r
        q = np.empty(4)
        q[i] = 0.5 * r
        q[j] = (m[j, i] + m[i, j]) * s
        q[k] = (m[k, i] + m[i, k]) * s
        q[3] = (m[k, j] - m[j, k]) * s
    if q[3] < 0:
        q = -q
    return (q / np.linalg.norm(q)).astype(np.float32)


def mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    t = a[..., 7:8] * quat_rotate(a[..., 3:7], b[..., :3]) + a[..., :3]
    q = quat_mul(a[..., 3:7], b[..., 3:7])
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    s = a[..., 7:8] * b[..., 7:8]
    return np.concatenate([t, q, s], axis=-1).astype(np.float32)


def inv(g: np.ndarray) -> np.ndarray:
    qc = g[..., 3:7] * np.array([-1, -1, -1, 1], dtype=g.dtype)
    s_inv = 1.0 / np.maximum(g[..., 7:8], 1e-12)
    t = -s_inv * quat_rotate(qc, g[..., :3])
    return np.concatenate([t, qc, s_inv], axis=-1).astype(np.float32)


def from_matrix(m: np.ndarray, s: float = 1.0) -> np.ndarray:
    q = matrix_to_quat(np.asarray(m[:3, :3], dtype=np.float64))
    return np.concatenate([m[:3, 3], q, [s]]).astype(np.float32)


def to_pose_matrix(g: np.ndarray) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = quat_to_matrix(g[3:7])
    m[:3, 3] = g[:3]
    return m

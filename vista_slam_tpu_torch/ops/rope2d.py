"""2D rotary position embedding (RoPE2D) for ViT patch tokens.

Same function as vista_slam_tpu/ops/rope2d.py (reference:
vista_slam/sta_model/pos_embed/pos_embed.py:113-185): the head dimension D is
split into a y-half and an x-half; each half of size d = D/2 is rotated by
position-dependent sin/cos at frequencies ``1 / base**(k/(d/2))``. The tables
are built once per (grid, head dim, device) in float64 numpy and kept on the
device; the rotation is plain tensor arithmetic.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _tables_np(n_h: int, n_w: int, dim_head: int, base: float, n_special: int):
    """cos/sin tables [n_special + n_h*n_w, D] (float32). The ``n_special``
    leading tokens sit at position (-1, -1): the decoder's pose token
    (reference: sta_model.py:214-219)."""
    if dim_head % 4:
        raise ValueError(f"head dim {dim_head} must be divisible by 4 for RoPE2D")
    d = dim_head // 2  # per-axis half
    q = d // 2  # rotation pairs per axis
    inv_freq = 1.0 / (base ** (np.arange(q, dtype=np.float64) / q))
    ys, xs = np.meshgrid(np.arange(n_h), np.arange(n_w), indexing="ij")
    pos = np.stack([ys.reshape(-1), xs.reshape(-1)], axis=-1).astype(np.float64)
    if n_special:
        pos = np.concatenate([-np.ones((n_special, 2)), pos], axis=0)

    def axis_tables(p):
        f = p[:, None] * inv_freq[None, :]
        c, s = np.cos(f), np.sin(f)
        return np.concatenate([c, c], -1), np.concatenate([s, s], -1)

    cy, sy = axis_tables(pos[:, 0])
    cx, sx = axis_tables(pos[:, 1])
    cos = np.concatenate([cy, cx], axis=-1).astype(np.float32)
    sin = np.concatenate([sy, sx], axis=-1).astype(np.float32)
    return cos, sin


@functools.lru_cache(maxsize=64)
def _tables_on(n_h, n_w, dim_head, base, n_special, device: str):
    cos, sin = _tables_np(n_h, n_w, dim_head, base, n_special)
    # cached tensors must not be inference tensors, or a training step after
    # an inference-mode forward at the same grid could not save them
    with torch.inference_mode(False):
        return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


def rope2d_tables(n_h: int, n_w: int, dim_head: int, base: float = 100.0,
                  n_special: int = 0, device="cpu"):
    """(cos, sin) fp32 tables [n_special + n_h*n_w, dim_head] on ``device``."""
    return _tables_on(n_h, n_w, dim_head, float(base), n_special,
                      str(torch.device(device)))


def apply_rope2d(tokens: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """Rotate tokens [..., N, D] with tables [N, D]; within each axis half
    h = (h1, h2), rotate_half(h) = (-h2, h1) (reference:
    pos_embed.py:122-125,149-167). Computed in the tokens' dtype."""
    D = tokens.shape[-1]
    d = D // 2
    q = d // 2
    y, x = tokens[..., :d], tokens[..., d:]
    rot = torch.cat([-y[..., q:], y[..., :q], -x[..., q:], x[..., :q]], dim=-1)
    return tokens * cos.to(tokens.dtype) + rot * sin.to(tokens.dtype)

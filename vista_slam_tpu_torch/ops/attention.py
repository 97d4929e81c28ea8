"""Multi-head attention: the plain path and the dispatch to kernel K1.

Inputs are [B, H, N, Dh] (q, k, v already projected and RoPE-rotated), as
in vista_slam_tpu/ops/attention.py.
  * ``mha_plain``: the semantics of the JAX package's ``mha_xla`` — fp32
    logits and softmax, probabilities cast to v's dtype, fp32 accumulation,
    output in v's dtype (reference: vista_slam/sta_model/blocks/
    sta_blocks.py:129-148).
  * ``use_flash=True``: the hand-written Hopper flash-attention kernel
    (kernels/flash_attn.py) on CUDA tensors, its plain version on CPU ones.

``CALLS`` counts which path each call took, so a run can show that the
attention went where the configuration says.
"""

from __future__ import annotations

import torch

from ..kernels import flash_attn

CALLS = {"flash": 0, "plain": 0}


def mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> torch.Tensor:
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
        use_flash: bool | None = None) -> torch.Tensor:
    """``use_flash=None`` keeps the JAX package's rule (flash from 512
    query tokens on); where the card's crossover lies is not measured yet."""
    if use_flash is None:
        use_flash = q.shape[-2] >= 512
    if use_flash:
        CALLS["flash"] += 1
        out, _ = flash_attn.flash_attention(q.contiguous(), k.contiguous(),
                                            v.contiguous(), scale)
        return out
    CALLS["plain"] += 1
    return mha_plain(q, k, v, scale)

"""Multi-head attention: the plain path and the flash-attention kernels.

Inputs are [B, H, N, Dh] (q, k, v already projected and RoPE-rotated), as
in vista_slam_tpu/ops/attention.py.
  * ``mha_plain``: the semantics of the JAX package's ``mha_xla`` — fp32
    logits and softmax, probabilities cast to v's dtype, fp32 accumulation,
    output in v's dtype (reference: vista_slam/sta_model/blocks/
    sta_blocks.py:129-148); differentiated by autograd.
  * ``use_flash=True``: ``FlashAttention``, the counterpart of the JAX
    package's ``custom_vjp`` around its Pallas kernels (ops/pallas/flash.py):
    the forward is kernel K1 and saves q, k, v, out and lse; the backward
    computes delta = rowsum(dO * O) in fp32 and runs K2a (dq) and K2b
    (dk, dv) (kernels/flash_attn.py). CUDA tensors go to the kernels, CPU
    tensors to their plain versions.

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


class FlashAttention(torch.autograd.Function):
    """out = softmax(q k^T * scale) v through K1, with K2a/K2b backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_attn.flash_attention(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        B, H, Nq, _ = q.shape
        do = do.contiguous()
        acc = torch.float64 if do.dtype == torch.float64 else torch.float32
        delta = (do.to(acc) * out.to(acc)).sum(-1).reshape(B * H, Nq)
        dq, dk, dv = flash_attn.flash_attention_bwd(q, k, v, do, lse, delta, ctx.scale)
        return dq, dk, dv, None


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
        use_flash: bool | None = None) -> torch.Tensor:
    """``use_flash=None`` keeps the JAX package's rule (flash from 512
    query tokens on); where the card's crossover lies is not measured yet."""
    if use_flash is None:
        use_flash = q.shape[-2] >= 512
    if use_flash:
        CALLS["flash"] += 1
        return FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), scale)
    CALLS["plain"] += 1
    return mha_plain(q, k, v, scale)

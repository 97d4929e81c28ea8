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
    runs K2a (delta = rowsum(dO * O) in fp32, and dq) and K2b (dk, dv)
    (kernels/flash_attn.py). CUDA tensors go to the kernels, CPU tensors
    to their plain versions.
  * ``fused_train=True``: ``FusedTrainAttention``, the counterpart of the
    JAX package's ``fused_attention`` (ops/pallas/attn_train.py), for
    N_q == N_kv <= ``MAX_FUSED_TOKENS`` below the flash threshold: the
    forward is kernel K3a (saving q, k, v, out and lse), the backward
    computes delta in fp32 and runs K3b, which emits dq, dk and dv in one
    kernel (kernels/attn_train.py).

``CALLS`` counts which path each call took, so a run can show that the
attention went where the configuration says.
"""

from __future__ import annotations

import torch

from ..kernels import attn_train, flash_attn

CALLS = {"flash": 0, "plain": 0, "fused": 0}
MAX_FUSED_TOKENS = attn_train.MAX_FUSED_TOKENS


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
        do = do.contiguous()
        dq, dk, dv = flash_attn.flash_attention_bwd(q, k, v, out, do, lse, ctx.scale)
        return dq, dk, dv, None


class FusedTrainAttention(torch.autograd.Function):
    """out = softmax(q k^T * scale) v through K3a, with the one-kernel K3b
    backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = attn_train.fused_attention_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = flash_attn.delta_plain(do, out)  # rowsum(dO * O); K2a forms its own
        dq, dk, dv = attn_train.fused_attention_bwd(q, k, v, do, lse, delta, ctx.scale)
        return dq, dk, dv, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """q/k/v [B, H, N, D] -> [B, H, N, D] through K3a/K3b; N_q == N_kv
    <= MAX_FUSED_TOKENS, as the JAX package's ``fused_attention`` demands."""
    if q.shape[-2] != k.shape[-2]:
        raise ValueError("fused_attention expects N_q == N_kv; use "
                         "flash_attention for asymmetric lengths")
    if q.shape[-2] > MAX_FUSED_TOKENS:
        raise ValueError(f"fused_attention is capped at {MAX_FUSED_TOKENS} tokens "
                         f"(got {q.shape[-2]}); use flash_attention for long sequences")
    return FusedTrainAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(),
                                     float(scale))


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
        use_flash: bool | None = None, fused_train: bool = False) -> torch.Tensor:
    """The JAX package's dispatch order: ``use_flash`` (None = the JAX
    package's rule, flash from 512 query tokens on; where the card's
    crossover lies is not measured yet) wins; then, with ``fused_train``,
    the fused kernels for N_q == N_kv <= MAX_FUSED_TOKENS; else plain."""
    n = q.shape[-2]
    if use_flash is None:
        use_flash = n >= 512
    if use_flash:
        CALLS["flash"] += 1
        return FlashAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), scale)
    if fused_train and n == k.shape[-2] and n <= MAX_FUSED_TOKENS:
        CALLS["fused"] += 1
        return fused_attention(q, k, v, scale)
    CALLS["plain"] += 1
    return mha_plain(q, k, v, scale)

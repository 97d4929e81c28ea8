"""Kernel K1: flash-attention forward, hand-written for Hopper.

Port of the TPU kernel ``vista_slam_tpu/ops/pallas/flash.py:_attn_kernel``
(entry ``flash_attention``). The CUDA source is ``csrc/flash_attn_fwd.cu``;
its header says what bounds it on the card and how the design answers that.

``flash_attention(q, k, v, scale)`` returns ``(out, lse)``:
  q [B, H, Nq, 64], k/v [B, H, Nk, 64], bf16 or fp32, contiguous;
  out [B, H, Nq, 64] in q's dtype; lse fp32 [B*H, Nq].
Tensors on the CPU go to ``flash_attention_plain``, the same function in
plain PyTorch. CUDA tensors go to the kernel or raise; there is no fallback.
``LAUNCHES`` counts kernel launches (and nothing else).
"""

from __future__ import annotations

import ctypes

import torch

from .build import BuiltLibrary, build

SOURCE = "flash_attn_fwd.cu"
HEAD_DIM = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = 0
_built: BuiltLibrary | None = None


def load() -> BuiltLibrary:
    """Build (first call only) and load the kernel library."""
    global _built
    if _built is None:
        built = build(SOURCE)
        fn = built.lib.flash_attn_fwd
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _built = built
    return _built


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: fp32 logits and softmax
    statistics, unnormalised probabilities cast to v's dtype before the PV
    product (fp32 accumulation), division by the fp32 row sum."""
    B, H, Nq, D = q.shape
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    out = (o / denom).to(q.dtype)
    lse = (m + torch.log(denom)).reshape(B * H, Nq)
    return out, lse


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if not (q.device == k.device == v.device) or q.device.type != "cuda":
        raise ValueError(f"flash_attention: q/k/v must share one CUDA device, "
                         f"got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPE_CODE or not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_attention: dtypes must be one of bf16/fp32 "
                         f"and equal, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: want q [B,H,Nq,D], k/v [B,H,Nk,D], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[0] != k.shape[0] or q.shape[1] != k.shape[1] or q.shape[3] != k.shape[3]:
        raise ValueError(f"flash_attention: B/H/D of q {tuple(q.shape)} and "
                         f"k {tuple(k.shape)} differ")
    if q.shape[3] != HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {q.shape[3]} != {HEAD_DIM}")
    if q.shape[2] < 1 or k.shape[2] < 1:
        raise ValueError("flash_attention: empty query or key set")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q/k/v must be contiguous")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """q [B,H,Nq,64], k/v [B,H,Nk,64] -> (out [B,H,Nq,64], lse [B*H,Nq])."""
    global LAUNCHES
    if q.device.type == k.device.type == v.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale)
    _check(q, k, v)
    B, H, Nq, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B * H, Nq), dtype=torch.float32, device=q.device)
    fn = load().lib.flash_attn_fwd
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), lse.data_ptr(), B * H, Nq, k.shape[2],
                 float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_fwd launch failed: cudaError_t {err}")
    LAUNCHES += 1
    return out, lse

"""Kernels K1 (flash-attention forward) and K2a/K2b (its backward),
hand-written for Hopper.

Ports of the TPU kernels in ``vista_slam_tpu/ops/pallas/flash.py``:
``_attn_kernel`` (K1, source ``csrc/flash_attn_fwd.cu``), ``_bwd_dq_kernel``
(K2a) and ``_bwd_dkv_kernel`` (K2b, both in ``csrc/flash_attn_bwd.cu``).
Each source's header says what bounds it on the card and how the design
answers that.

``flash_attention(q, k, v, scale)`` returns ``(out, lse)``:
  q [B, H, Nq, 64], k/v [B, H, Nk, 64], bf16 or fp32, contiguous, on
  16-byte boundaries;
  out [B, H, Nq, 64] in q's dtype; lse fp32 [B*H, Nq].
``flash_attention_bwd(q, k, v, do, lse, delta, scale)`` returns
``(dq, dk, dv)`` in the inputs' dtype, with delta = rowsum(do * out) fp32
[B*H, Nq] computed by the caller (ops/attention.py).
Tensors on the CPU go to ``flash_attention_plain`` / ``flash_attention_bwd_plain``,
the same functions in plain PyTorch. CUDA tensors go to the kernels or
raise; there is no fallback. ``LAUNCHES`` (K1), ``LAUNCHES_DQ`` (K2a) and
``LAUNCHES_DKV`` (K2b) count kernel launches (and nothing else).
"""

from __future__ import annotations

import ctypes

import torch

from .build import BuiltLibrary, build

SOURCE = "flash_attn_fwd.cu"
SOURCE_BWD = "flash_attn_bwd.cu"
HEAD_DIM = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = 0       # K1
LAUNCHES_DQ = 0    # K2a
LAUNCHES_DKV = 0   # K2b
_built: BuiltLibrary | None = None
_built_bwd: BuiltLibrary | None = None


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


def load_bwd() -> BuiltLibrary:
    """Build (first call only) and load the backward kernels' library."""
    global _built_bwd
    if _built_bwd is None:
        built = build(SOURCE_BWD)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        built.lib.flash_attn_bwd_dq.argtypes = (
            [i32] + [ptr] * 7 + [i32, i32, i32, ctypes.c_float, ptr])
        built.lib.flash_attn_bwd_dkv.argtypes = (
            [i32] + [ptr] * 8 + [i32, i32, i32, ctypes.c_float, ptr])
        built.lib.flash_attn_bwd_dq.restype = i32
        built.lib.flash_attn_bwd_dkv.restype = i32
        _built_bwd = built
    return _built_bwd


def reset_launches() -> None:
    global LAUNCHES, LAUNCHES_DQ, LAUNCHES_DKV
    LAUNCHES = LAUNCHES_DQ = LAUNCHES_DKV = 0


def _acc(dtype: torch.dtype) -> torch.dtype:
    """Accumulation type of the plain versions: fp32, or fp64 for fp64
    inputs (gradient checks)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: fp32 logits and softmax
    statistics, unnormalised probabilities cast to v's dtype before the PV
    product (fp32 accumulation), division by the fp32 row sum."""
    B, H, Nq, D = q.shape
    acc = _acc(q.dtype)
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    denom = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).to(acc), v.to(acc))
    out = (o / denom).to(q.dtype)
    lse = (m + torch.log(denom)).reshape(B * H, Nq)
    return out, lse


def _bwd_probs(q, k, v, do, lse, delta, scale):
    """P = exp(S - lse) and dS = P * (dP - delta) in the accumulation type."""
    B, H, Nq, D = q.shape
    acc = _acc(q.dtype)
    s = torch.matmul(q.to(acc), k.to(acc).transpose(-1, -2)) * scale
    p = torch.exp(s - lse.reshape(B, H, Nq, 1).to(acc))
    dp = torch.matmul(do.to(acc), v.to(acc).transpose(-1, -2))
    return p, p * (dp - delta.reshape(B, H, Nq, 1).to(acc))


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, scale):
    """K2a's function in plain PyTorch: dS cast to k's dtype before
    dQ = dS K, fp32 accumulation, scale applied after it."""
    acc = _acc(q.dtype)
    _, ds = _bwd_probs(q, k, v, do, lse, delta, scale)
    return (torch.matmul(ds.to(k.dtype).to(acc), k.to(acc)) * scale).to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, scale):
    """K2b's function in plain PyTorch: P cast to do's dtype before
    dV = P^T dO, dS cast to q's dtype before dK = dS^T Q, fp32
    accumulation, scale applied after it."""
    acc = _acc(q.dtype)
    p, ds = _bwd_probs(q, k, v, do, lse, delta, scale)
    dk = torch.matmul(ds.to(q.dtype).to(acc).transpose(-1, -2), q.to(acc)) * scale
    dv = torch.matmul(p.to(do.dtype).to(acc).transpose(-1, -2), do.to(acc))
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_plain(q, k, v, do, lse, delta, scale):
    """K2a and K2b's functions in plain PyTorch: (dq, dk, dv)."""
    return (flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, scale),
            *flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, scale))


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
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q/k/v must start on 16-byte boundaries "
                         "(the kernels copy 16 bytes at a time)")


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


def _check_bwd(q, k, v, do, lse, delta) -> None:
    _check(q, k, v)
    B, H, Nq, D = q.shape
    if (do.shape != q.shape or do.dtype != q.dtype or not do.is_contiguous()
            or do.device != q.device):
        raise ValueError(f"flash_attention_bwd: do must be a contiguous "
                         f"{tuple(q.shape)} {q.dtype} tensor on {q.device}, got "
                         f"{tuple(do.shape)} {do.dtype} on {do.device}")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != (B * H, Nq) or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"flash_attention_bwd: {name} must be a contiguous "
                             f"fp32 [{B * H}, {Nq}] tensor on {q.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def flash_attention_bwd_dq(q, k, v, do, lse, delta, scale) -> torch.Tensor:
    """K2a: dq of ``flash_attention``'s out."""
    global LAUNCHES_DQ
    if _on_cpu(q, k, v, do, lse, delta):
        return flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, scale)
    _check_bwd(q, k, v, do, lse, delta)
    B, H, Nq, D = q.shape
    dq = torch.empty_like(q)
    fn = load_bwd().lib.flash_attn_bwd_dq
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                 B * H, Nq, k.shape[2], float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd_dq launch failed: cudaError_t {err}")
    LAUNCHES_DQ += 1
    return dq


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale):
    """K2b: (dk, dv) of ``flash_attention``'s out."""
    global LAUNCHES_DKV
    if _on_cpu(q, k, v, do, lse, delta):
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, scale)
    _check_bwd(q, k, v, do, lse, delta)
    B, H, Nq, D = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    fn = load_bwd().lib.flash_attn_bwd_dkv
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), B * H, Nq, k.shape[2], float(scale), stream)
    if err != 0:
        raise RuntimeError(f"flash_attn_bwd_dkv launch failed: cudaError_t {err}")
    LAUNCHES_DKV += 1
    return dk, dv


def flash_attention_bwd(q, k, v, do, lse, delta, scale):
    """Gradients (dq, dk, dv) of ``flash_attention``'s out: K2a then K2b."""
    return (flash_attention_bwd_dq(q, k, v, do, lse, delta, scale),
            *flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale))

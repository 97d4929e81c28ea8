"""Kernels K3a (fused short-sequence attention forward) and K3b (its
one-kernel backward), hand-written for Hopper.

Ports of the TPU kernels in ``vista_slam_tpu/ops/pallas/attn_train.py``:
``_fwd_kernel`` (K3a) and ``_bwd_kernel`` (K3b), both in
``csrc/attn_train.cu``, whose header says what bounds them on the card and
how the design answers that.

``fused_attention_fwd(q, k, v, scale)`` returns ``(out, lse)``:
  q/k/v [B, H, N, 64] with N <= MAX_FUSED_TOKENS, bf16 or fp32, contiguous;
  out [B, H, N, 64] in q's dtype; lse fp32 [B*H, N].
``fused_attention_bwd(q, k, v, do, lse, delta, scale)`` returns
``(dq, dk, dv)`` in the inputs' dtype from one kernel, with delta =
rowsum(do * out) fp32 [B*H, N] computed by the caller (ops/attention.py).
Tensors on the CPU go to ``fused_attention_fwd_plain`` /
``fused_attention_bwd_plain``, the same functions in plain PyTorch. CUDA
tensors go to the kernels or raise; there is no fallback. ``LAUNCHES_FWD``
(K3a) and ``LAUNCHES_BWD`` (K3b) count kernel launches (and nothing else).
"""

from __future__ import annotations

import ctypes

import torch

from . import flash_attn
from .build import BuiltLibrary, build

SOURCE = "attn_train.cu"
MAX_FUSED_TOKENS = 1024  # as ops/pallas/attn_train.py's
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES_FWD = 0  # K3a
LAUNCHES_BWD = 0  # K3b
_built: BuiltLibrary | None = None
_scratch_tokens = 0  # bf16 K3b sums dQ on chip up to this many tokens (from load())


def load() -> BuiltLibrary:
    """Build (first call only) and load the kernel library."""
    global _built, _scratch_tokens
    if _built is None:
        built = build(SOURCE)
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        built.lib.attn_train_fwd.argtypes = [i32] + [ptr] * 5 + [i32, i32, ctypes.c_float, ptr]
        built.lib.attn_train_bwd.argtypes = [i32] + [ptr] * 10 + [i32, i32, ctypes.c_float, ptr]
        built.lib.attn_train_fwd.restype = i32
        built.lib.attn_train_bwd.restype = i32
        built.lib.attn_train_bwd_scratch_tokens.restype = i32
        _scratch_tokens = built.lib.attn_train_bwd_scratch_tokens()
        _built = built
    return _built


def reset_launches() -> None:
    global LAUNCHES_FWD, LAUNCHES_BWD
    LAUNCHES_FWD = LAUNCHES_BWD = 0


def fused_attention_fwd_plain(q, k, v, scale):
    """K3a's function in plain PyTorch: K1's with N_q == N_kv (fp32 logits
    and exact softmax statistics, unnormalised probabilities cast to v's
    dtype before the PV product with fp32 accumulation, division by the
    fp32 row sum, lse = max + log(rowsum)), the rounding points of the TPU
    kernel."""
    return flash_attn.flash_attention_plain(q, k, v, scale)


def fused_attention_bwd_plain(q, k, v, do, lse, delta, scale):
    """K3b's function in plain PyTorch: K2a's and K2b's together (P =
    exp(S - lse); dV = (P cast to do's dtype)^T dO; dS = P * (dO V^T -
    delta) cast to q's dtype; dQ = dS K * scale, dK = dS^T Q * scale, fp32
    accumulation), the rounding points of the TPU kernel."""
    return flash_attn.flash_attention_bwd_plain(q, k, v, do, lse, delta, scale)


def _check(q, k, v) -> None:
    """K1's checks (one CUDA device, bf16/fp32, [B,H,N,64], contiguous) and
    the fused kernels' own: N_q == N_kv <= MAX_FUSED_TOKENS, B*H <= 65535."""
    flash_attn._check(q, k, v)
    B, H, N, _ = q.shape
    if k.shape[2] != N or N > MAX_FUSED_TOKENS:
        raise ValueError(f"fused_attention: want N_q == N_kv <= {MAX_FUSED_TOKENS}, got "
                         f"{N} and {k.shape[2]}")
    if B * H > 65535:
        raise ValueError(f"fused_attention: B*H = {B * H} > 65535")


def fused_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """K3a: q/k/v [B,H,N,64] -> (out [B,H,N,64], lse [B*H,N])."""
    global LAUNCHES_FWD
    if q.device.type == k.device.type == v.device.type == "cpu":
        return fused_attention_fwd_plain(q, k, v, scale)
    _check(q, k, v)
    B, H, N, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B * H, N), dtype=torch.float32, device=q.device)
    fn = load().lib.attn_train_fwd
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), lse.data_ptr(), B * H, N, float(scale), stream)
    if err != 0:
        raise RuntimeError(f"attn_train_fwd launch failed: cudaError_t {err}")
    LAUNCHES_FWD += 1
    return out, lse


def fused_attention_bwd(q, k, v, do, lse, delta, scale):
    """K3b: (dq, dk, dv) of ``fused_attention_fwd``'s out, from one kernel."""
    global LAUNCHES_BWD
    if all(t.device.type == "cpu" for t in (q, k, v, do, lse, delta)):
        return fused_attention_bwd_plain(q, k, v, do, lse, delta, scale)
    _check(q, k, v)
    flash_attn._check_bwd(q, k, v, do, lse, delta)  # do, lse and delta
    B, H, N, D = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # bf16 sums dQ on chip; past the library's _scratch_tokens its fp32
    # partial sums go from one group of key tiles to the next through a
    # scratch [B*H, N rounded up to 64, D] that each slice's block owns (the
    # fp32 kernel sums in dq itself)
    fn = load().lib.attn_train_bwd
    n_pad = -(-N // 64) * 64
    scratch = (torch.empty((B * H, n_pad, D), dtype=torch.float32, device=q.device)
               if q.dtype == torch.bfloat16 and N > _scratch_tokens else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), B * H, N,
                 float(scale), stream)
    if err != 0:
        raise RuntimeError(f"attn_train_bwd launch failed: cudaError_t {err}")
    LAUNCHES_BWD += 1
    return dq, dk, dv

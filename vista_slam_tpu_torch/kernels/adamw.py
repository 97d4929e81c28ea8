"""Kernel K5: the fused clipped AdamW step with bf16 moments, hand-written
for Hopper.

Port of the TPU kernel ``vista_slam_tpu/ops/pallas/adam8.py:_adam_kernel_bf16``
(entry ``fused_adamw_bf16``). The CUDA source is ``csrc/adamw_bf16.cu``; its
header says what bounds it on the card and how the design answers that.

``fused_adamw_bf16(p, g, mu, nu, scalars, b1=, b2=, eps=, wd=)`` updates one
parameter leaf in place: p and g fp32, mu and nu bf16 with p's number of
elements (any shape; the optimizer keeps them as [C, 1024] like the JAX
package), scalars fp32 [4] = (clip coefficient, lr, 1 - b1^t, 1 - b2^t) on
p's device. Tensors on the CPU go to ``fused_adamw_bf16_plain``, the same
function in plain PyTorch; CUDA tensors go to the kernel or raise.
``LAUNCHES`` counts kernel launches (and nothing else).
"""

from __future__ import annotations

import ctypes

import torch

from .build import BuiltLibrary, build

SOURCE = "adamw_bf16.cu"

LAUNCHES = 0
_built: BuiltLibrary | None = None


def load() -> BuiltLibrary:
    """Build (first call only) and load the kernel library."""
    global _built
    if _built is None:
        built = build(SOURCE)
        fn = built.lib.adamw_bf16
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_float] * 6 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _built = built
    return _built


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def fused_adamw_bf16_plain(p, g, mu, nu, scalars, *, b1: float, b2: float,
                           eps: float, wd: float) -> None:
    """The kernel's function in plain PyTorch (fp32 math, in place)."""
    coef, lr, c1, c2 = scalars.unbind()
    g = g.reshape(p.shape) * coef
    m = b1 * mu.reshape(p.shape).float() + (1.0 - b1) * g
    v = b2 * nu.reshape(p.shape).float() + (1.0 - b2) * g * g
    u = (m / c1) / (torch.sqrt(v / c2) + eps)
    p.copy_(p - lr * (u + wd * p))
    mu.copy_(m.reshape(mu.shape))
    nu.copy_(v.reshape(nu.shape))


def _check(p, g, mu, nu, scalars) -> None:
    devs = {t.device for t in (p, g, mu, nu, scalars)}
    if len(devs) != 1 or p.device.type != "cuda":
        raise ValueError(f"fused_adamw_bf16: tensors must share one CUDA device, "
                         f"got {sorted(map(str, devs))}")
    want = ((p, torch.float32, "p"), (g, torch.float32, "g"), (mu, torch.bfloat16, "mu"),
            (nu, torch.bfloat16, "nu"), (scalars, torch.float32, "scalars"))
    for t, dtype, name in want:
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"fused_adamw_bf16: {name} must be contiguous {dtype}, "
                             f"got {t.dtype} (contiguous={t.is_contiguous()})")
    n = p.numel()
    if not (g.numel() == mu.numel() == nu.numel() == n) or scalars.numel() != 4:
        raise ValueError(f"fused_adamw_bf16: sizes p {n}, g {g.numel()}, mu "
                         f"{mu.numel()}, nu {nu.numel()}, scalars {scalars.numel()}")


def fused_adamw_bf16(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                     nu: torch.Tensor, scalars: torch.Tensor, *, b1: float,
                     b2: float, eps: float, wd: float) -> None:
    """One fused AdamW step for one leaf, in place (p, mu, nu)."""
    global LAUNCHES
    if all(t.device.type == "cpu" for t in (p, g, mu, nu, scalars)):
        fused_adamw_bf16_plain(p, g, mu, nu, scalars, b1=b1, b2=b2, eps=eps, wd=wd)
        return
    _check(p, g, mu, nu, scalars)
    fn = load().lib.adamw_bf16
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = fn(p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(),
                 scalars.data_ptr(), p.numel(), b1, 1.0 - b1, b2, 1.0 - b2, eps,
                 wd, stream)
    if err != 0:
        raise RuntimeError(f"adamw_bf16 launch failed: cudaError_t {err}")
    LAUNCHES += 1

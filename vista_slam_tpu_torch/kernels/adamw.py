"""Kernels K5 and K4: the fused clipped AdamW step with bf16 moments and
with int8 moments, hand-written for Hopper.

Ports of the TPU kernels ``vista_slam_tpu/ops/pallas/adam8.py:
_adam_kernel_bf16`` (K5, entry ``fused_adamw_bf16``, CUDA source
``csrc/adamw_bf16.cu``) and ``_adam_kernel_int8`` (K4, entry
``fused_adamw_int8``, CUDA source ``csrc/adamw_int8.cu``). Each source's
header says what bounds it on the card and how the design answers that.

``fused_adamw_bf16(p, g, mu, nu, scalars, b1=, b2=, eps=, wd=)`` updates one
parameter leaf in place: p and g fp32, mu and nu bf16 with p's number of
elements (any shape; the optimizer keeps them as [C, 1024] like the JAX
package), scalars fp32 [4] = (clip coefficient, lr, 1 - b1^t, 1 - b2^t) on
p's device. Tensors on the CPU go to ``fused_adamw_bf16_plain``, the same
function in plain PyTorch; CUDA tensors go to the kernel or raise.
``LAUNCHES`` counts K5's launches (and nothing else).

``fused_adamw_int8(p, g, mu_q, mu_s, nu_q, nu_s, scalars, b1=, b2=, eps=,
wd=)`` updates one leaf in place: p and g are fp32 views of the leaf in the
JAX package's layout (``models/convert.py::jax_layouts``; any strides, the
same for both, at most 4 dims), whose row-major flatten is cut into C rows
of ``QBLOCK`` elements; mu_q and nu_q int8 [C, QBLOCK] (linear and
log-domain codes), mu_s and nu_s fp32 [C, 1] (their row scales); scalars as
above. CPU tensors go to ``fused_adamw_int8_plain``; CUDA tensors go to the
kernel or raise. ``LAUNCHES_INT8`` counts K4's launches.
"""

from __future__ import annotations

import ctypes

import torch

from .build import BuiltLibrary, build

SOURCE = "adamw_bf16.cu"
SOURCE_INT8 = "adamw_int8.cu"
QBLOCK = 1024           # K4's quantization block: one row of the leaf's view
NU_LOG_RANGE = 13.8155  # ln(1e6): nu's log-domain codes span 6 decades

LAUNCHES = 0       # K5
LAUNCHES_INT8 = 0  # K4
_built: BuiltLibrary | None = None
_built_int8: BuiltLibrary | None = None


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


def load_int8() -> BuiltLibrary:
    """Build (first call only) and load K4's library."""
    global _built_int8
    if _built_int8 is None:
        built = build(SOURCE_INT8)
        ptr, i64p = ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong)
        fn = built.lib.adamw_int8
        fn.argtypes = ([ptr, ptr, ctypes.c_int, i64p, i64p] + [ptr] * 5 + [ctypes.c_int]
                       + [ctypes.c_float] * 7 + [ptr])
        fn.restype = ctypes.c_int
        _built_int8 = built
    return _built_int8


def reset_launches() -> None:
    global LAUNCHES, LAUNCHES_INT8
    LAUNCHES = LAUNCHES_INT8 = 0


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


def fused_adamw_int8_plain(p, g, mu_q, mu_s, nu_q, nu_s, scalars, *, b1: float,
                           b2: float, eps: float, wd: float) -> None:
    """K4's function in plain PyTorch (fp32 math, in place), with the TPU
    kernel's rounding points. p and g are the leaf's JAX-layout views: their
    row-major flatten, cut into rows of QBLOCK, gives the kernel's blocks."""
    C = mu_q.shape[0]
    # divisors as tensors: torch on a card divides by a Python number through
    # its reciprocal, which rounds differently from the kernel's division
    k, c127 = (torch.tensor(x, dtype=torch.float32, device=p.device)
               for x in (NU_LOG_RANGE / 126.0, 127.0))
    coef, lr, c1, c2 = scalars.unbind()
    g = g.reshape(C, QBLOCK) * coef
    mu = mu_q.float() * mu_s
    nc = nu_q.float()
    nu = torch.where(nc > 0.0, nu_s * torch.exp((nc - 127.0) * k), 0.0)
    mu = b1 * mu + (1.0 - b1) * g
    nu = b2 * nu + (1.0 - b2) * g * g
    u = (mu / c1) / (torch.sqrt(nu / c2) + eps)
    p32 = p.reshape(C, QBLOCK)
    p.copy_((p32 - lr * (u + wd * p32)).reshape(p.shape))
    ms = torch.clamp(mu.abs().amax(dim=1, keepdim=True), min=1e-10) / c127
    mu_q.copy_(torch.round(mu / ms).to(torch.int8))
    mu_s.copy_(ms)
    ss = torch.clamp(nu.amax(dim=1, keepdim=True), min=1e-30)
    logc = 127.0 + torch.log(torch.clamp(nu, min=1e-38) / ss) / k
    nu_q.copy_(torch.clamp(torch.round(logc), 1.0, 127.0).to(torch.int8))
    nu_s.copy_(ss)


def _strides(t: torch.Tensor) -> list[int]:
    """The strides that address anything: those of dims longer than 1 (a
    size-1 dim's stride is arbitrary, e.g. in a gradient of a 1x1 conv)."""
    return [st for st, n in zip(t.stride(), t.shape) if n > 1]


def _check_int8(p, g, mu_q, mu_s, nu_q, nu_s, scalars) -> None:
    ts = (p, g, mu_q, mu_s, nu_q, nu_s, scalars)
    devs = {t.device for t in ts}
    if len(devs) != 1 or p.device.type != "cuda":
        raise ValueError(f"fused_adamw_int8: tensors must share one CUDA device, "
                         f"got {sorted(map(str, devs))}")
    want = ((p, torch.float32, "p"), (g, torch.float32, "g"), (mu_q, torch.int8, "mu_q"),
            (mu_s, torch.float32, "mu_s"), (nu_q, torch.int8, "nu_q"),
            (nu_s, torch.float32, "nu_s"), (scalars, torch.float32, "scalars"))
    for t, dtype, name in want:
        if t.dtype != dtype:
            raise ValueError(f"fused_adamw_int8: {name} must be {dtype}, got {t.dtype}")
    for t, name in ((mu_q, "mu_q"), (mu_s, "mu_s"), (nu_q, "nu_q"), (nu_s, "nu_s"),
                    (scalars, "scalars")):
        if not t.is_contiguous():
            raise ValueError(f"fused_adamw_int8: {name} must be contiguous")
    C = mu_q.shape[0] if mu_q.dim() == 2 else -1
    if (mu_q.shape != (C, QBLOCK) or nu_q.shape != (C, QBLOCK) or mu_s.numel() != C
            or nu_s.numel() != C or scalars.numel() != 4):
        raise ValueError(f"fused_adamw_int8: want codes [C, {QBLOCK}] and scales of C "
                         f"elements, got {tuple(mu_q.shape)}, {tuple(nu_q.shape)}, "
                         f"{tuple(mu_s.shape)}, {tuple(nu_s.shape)}")
    if (p.shape != g.shape or _strides(p) != _strides(g) or p.numel() != C * QBLOCK
            or not 1 <= p.dim() <= 4 or p.numel() >= 2 ** 31):
        raise ValueError(f"fused_adamw_int8: p and g must be views of one shape and "
                         f"strides (at most 4 dims) of {C} x {QBLOCK} elements, got "
                         f"{tuple(p.shape)}/{p.stride()} and {tuple(g.shape)}/{g.stride()}")


def fused_adamw_int8(p: torch.Tensor, g: torch.Tensor, mu_q: torch.Tensor,
                     mu_s: torch.Tensor, nu_q: torch.Tensor, nu_s: torch.Tensor,
                     scalars: torch.Tensor, *, b1: float, b2: float, eps: float,
                     wd: float) -> None:
    """One fused int8-moment AdamW step for one leaf, in place (p, codes,
    scales)."""
    global LAUNCHES_INT8
    ts = (p, g, mu_q, mu_s, nu_q, nu_s, scalars)
    if all(t.device.type == "cpu" for t in ts):
        fused_adamw_int8_plain(*ts, b1=b1, b2=b2, eps=eps, wd=wd)
        return
    _check_int8(*ts)
    sizes = (ctypes.c_longlong * p.dim())(*p.shape)
    strides = (ctypes.c_longlong * p.dim())(*p.stride())
    fn = load_int8().lib.adamw_int8
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = fn(p.data_ptr(), g.data_ptr(), p.dim(), sizes, strides, mu_q.data_ptr(),
                 mu_s.data_ptr(), nu_q.data_ptr(), nu_s.data_ptr(), scalars.data_ptr(),
                 mu_q.shape[0], b1, 1.0 - b1, b2, 1.0 - b2, eps, wd,
                 NU_LOG_RANGE / 126.0, stream)
    if err != 0:
        raise RuntimeError(f"adamw_int8 launch failed: cudaError_t {err}")
    LAUNCHES_INT8 += 1

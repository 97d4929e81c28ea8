"""AdamW for the training step, in PyTorch: the fused optimizers (kernels
K5 and K4), the fp32 optax chain and the JAX package's compressed carriers.

``FusedAdamW`` is the counterpart of vista_slam_tpu/train/
quantized_opt.py::make_fused_adamw: one step is clip-by-global-norm ->
AdamW(b1, b2) with bias correction -> masked weight decay -> lr from the
schedule, applied in place. Leaves with at least ``MIN_QUANT_SIZE``
elements and a multiple of ``QBLOCK`` go through a kernel; the others keep
fp32 moments and take the same math in plain PyTorch.
  * ``state_dtype="bf16_fused"``: bf16 moments [C, QBLOCK] through K5
    (kernels/adamw.py::fused_adamw_bf16). They are elementwise, so the
    leaf is flattened in torch order.
  * ``state_dtype="int8_fused"``: int8 codes [C, QBLOCK] with one fp32
    scale per row for each moment (``FusedInt8Leaf``) through K4
    (kernels/adamw.py::Int8Table, built at ``init``: one launch per pass
    for all the leaves with a gradient). The scales belong to blocks of
    1024 elements of the leaf's flatten in the JAX package's layout, so K4
    takes each parameter through its JAX-layout view
    (models/convert.py::jax_layouts) and its blocks are the JAX package's.

``ChainAdamW`` is ``optax.chain(clip_by_global_norm(clip), adamw(...))``
in plain PyTorch: with fp32 moments, the JAX package's
``state_dtype="fp32"``, or with the moments carried compressed between
steps, its ``scale_by_adam_q``/``adamw_q`` (``"bf16"``: bf16 moments;
``"int8"``: blocks of 256 elements of the JAX-layout flatten with signed
int8 mu codes and sqrt-domain uint8 nu codes, one fp32 scale per block),
which the JAX package runs as XLA code, not as a kernel.

All read the gradients from ``.grad`` and skip parameters without one.
``init`` takes the weight-decay mask per parameter (``decay``) and, for
the modes whose blocks follow the layout, the JAX-layout permutation of
each parameter (``layouts``, identity by default); the training step takes
both from models/convert.py (the JAX package decays leaves with ``ndim >
1`` in its own layout). The step count lives on the host; the step scalars
go to the device as one fp32 tensor, the clip coefficient computed on the
device, so a step never waits for the gradient norm.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from ..kernels.adamw import QBLOCK, Int8Table, fused_adamw_bf16

MIN_QUANT_SIZE = 2048
BLOCK = 256  # the carriers' int8 block (quantized_opt.py's BLOCK)


def fused_eligible(p: torch.Tensor) -> bool:
    return p.numel() >= MIN_QUANT_SIZE and p.numel() % QBLOCK == 0


class FusedBf16Leaf(NamedTuple):
    mu: torch.Tensor  # bf16 [C, QBLOCK]
    nu: torch.Tensor  # bf16 [C, QBLOCK]


class FusedInt8Leaf(NamedTuple):
    mu_q: torch.Tensor  # int8 [C, QBLOCK], linear codes
    mu_s: torch.Tensor  # fp32 [C, 1], max|mu| / 127 per row
    nu_q: torch.Tensor  # int8 [C, QBLOCK], log-domain codes
    nu_s: torch.Tensor  # fp32 [C, 1], max nu per row


class Fp32Leaf(NamedTuple):
    mu: torch.Tensor  # fp32 (ChainAdamW: as carried, bf16 or QMoment for large leaves)
    nu: torch.Tensor


def _global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (optax.global_norm), in
    fp32: the 2-norm of the gradients' 2-norms, one multi-tensor call for
    those, summed in fp64 (the rounded result stays within an ulp or two of
    an fp32 sum's, as a norm of fp32 norms alone would not)."""
    norms = torch._foreach_norm([g.float() for g in grads], 2, dtype=torch.float64)
    return torch.linalg.vector_norm(torch.stack(norms)).float()


class _AdamWBase:
    state_dtype = "fp32"

    def __init__(self, schedule: Callable[[int], np.float32], b1: float, b2: float,
                 eps: float, weight_decay: float, clip: float):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.clip = weight_decay, clip
        self.count = 0
        self.params: list[torch.Tensor] = []
        self.decay: list[bool] = []
        self.moments: list = []

    def init(self, params: Sequence[torch.Tensor], decay: Sequence[bool],
             layouts: Sequence[tuple[int, ...]]) -> None:
        """Bind to ``params`` (updated in place by ``step``); ``decay[i]``
        says whether params[i] takes weight decay, and ``params[i].permute(
        layouts[i])`` is its view in the JAX package's layout
        (``models/convert.py::jax_layouts``)."""
        if not len(params) == len(decay) == len(layouts):
            raise ValueError(f"{len(params)} params, {len(decay)} decay flags, "
                             f"{len(layouts)} layouts")
        self.params, self.decay = list(params), [bool(d) for d in decay]
        self.layouts = [tuple(perm) for perm in layouts]
        self.moments = [self._init_leaf(p) for p in self.params]
        self.count = 0

    def _init_leaf(self, p: torch.Tensor):
        return Fp32Leaf(torch.zeros_like(p, dtype=torch.float32),
                        torch.zeros_like(p, dtype=torch.float32))

    def host_scalars(self) -> tuple[np.float32, np.float32, np.float32]:
        """(lr, 1 - b1^t, 1 - b2^t) of this step in float32, as optax
        computes them: lr = schedule(count) before the increment, t = count + 1."""
        one, t = np.float32(1.0), np.float32(self.count + 1)
        return (np.float32(self.schedule(self.count)),
                one - np.float32(self.b1) ** t, one - np.float32(self.b2) ** t)

    def _host_to(self, dev: torch.device) -> torch.Tensor:
        """host_scalars() as an fp32 [3] tensor on ``dev``, copied without
        waiting for the device (from pinned memory on a CUDA device)."""
        host = torch.tensor(self.host_scalars(), dtype=torch.float32)
        if dev.type == "cuda":
            host = host.pin_memory()
        return host.to(dev, non_blocking=True)

    def _live(self) -> list[int]:
        """Indices of the parameters that have a gradient."""
        return [i for i, p in enumerate(self.params) if p.grad is not None]


class FusedAdamW(_AdamWBase):
    """The fused AdamW with bf16 (``state_dtype="bf16_fused"``, K5) or int8
    (``"int8_fused"``, K4) moments."""

    def __init__(self, schedule, b1, b2, eps, weight_decay, clip,
                 state_dtype: str = "bf16_fused"):
        if state_dtype not in ("bf16_fused", "int8_fused"):
            raise ValueError(f"state_dtype must be bf16_fused|int8_fused, got {state_dtype!r}")
        super().__init__(schedule, b1, b2, eps, weight_decay, clip)
        self.state_dtype = state_dtype
        self.int8: Int8Table | None = None  # K4's table of the int8 leaves
        self.int8_index: list[int] = []     # the parameter of each of its leaves
        self.int8_ptrs: list[int] = []      # and its storage at init

    def init(self, params, decay, layouts) -> None:
        """As ``_AdamWBase.init``; K4's table then holds the storage of each
        int8 leaf's parameter and state. ``step`` raises if a parameter's
        storage was replaced since (``p.data = ...``, ``module.to(...)``):
        call ``init`` again after that. The state is only updated in place."""
        super().init(params, decay, layouts)
        self.int8_index = [i for i, m in enumerate(self.moments)
                           if isinstance(m, FusedInt8Leaf)]
        self.int8_ptrs = [self.params[i].data_ptr() for i in self.int8_index]
        self.int8 = Int8Table(
            [(self.params[i].data.permute(self.layouts[i]), *self.moments[i],
              self.weight_decay if self.decay[i] else 0.0) for i in self.int8_index],
            b1=self.b1, b2=self.b2, eps=self.eps) if self.int8_index else None

    def _init_leaf(self, p):
        if not fused_eligible(p):
            return super()._init_leaf(p)
        C, dev = p.numel() // QBLOCK, p.device
        if self.state_dtype == "int8_fused":
            # zero codes dequantize to exactly 0 whatever the scales say
            return FusedInt8Leaf(
                torch.zeros((C, QBLOCK), dtype=torch.int8, device=dev),
                torch.full((C, 1), 1e-10 / 127.0, dtype=torch.float32, device=dev),
                torch.zeros((C, QBLOCK), dtype=torch.int8, device=dev),
                torch.full((C, 1), 1e-30, dtype=torch.float32, device=dev))
        return FusedBf16Leaf(torch.zeros((C, QBLOCK), dtype=torch.bfloat16, device=dev),
                             torch.zeros((C, QBLOCK), dtype=torch.bfloat16, device=dev))

    @torch.no_grad()
    def step(self) -> None:
        live = self._live()
        if not live:
            return
        grads = {i: self.params[i].grad.contiguous() for i in live}
        dev = self.params[live[0]].device
        gnorm = _global_norm(list(grads.values()))
        coef = self.clip / torch.clamp(gnorm, min=self.clip)  # = min(1, clip/||g||)
        scalars = torch.cat([coef.reshape(1), self._host_to(dev)])
        _, lr, c1, c2 = scalars.unbind()
        b1, b2, eps = self.b1, self.b2, self.eps
        if self.int8 is not None:
            moved = [i for i, ptr in zip(self.int8_index, self.int8_ptrs)
                     if self.params[i].data_ptr() != ptr]
            if moved:
                raise RuntimeError(f"FusedAdamW: the storage of parameters {moved} was "
                                   "replaced since init; K4's table would update the old "
                                   "one: call init again")
            # p and g are both contiguous: their views address alike
            self.int8.step([grads[i].permute(self.layouts[i]) if i in grads else None
                            for i in self.int8_index], scalars)
        for i in live:
            p, m, g = self.params[i], self.moments[i], grads[i]
            wd = self.weight_decay if self.decay[i] else 0.0
            if isinstance(m, FusedInt8Leaf):
                continue
            if isinstance(m, FusedBf16Leaf):
                fused_adamw_bf16(p.data.view(-1), g.view(-1), m.mu, m.nu, scalars,
                                 b1=b1, b2=b2, eps=eps, wd=wd)
                continue
            # fp32 fallback: the same math in plain PyTorch
            g32 = g.float() * scalars[0]
            m.mu.copy_(b1 * m.mu + (1.0 - b1) * g32)
            m.nu.copy_(b2 * m.nu + (1.0 - b2) * g32 * g32)
            u = (m.mu / c1) / (torch.sqrt(m.nu / c2) + eps)
            p32 = p.float()
            p.copy_(p32 - lr * (u + wd * p32))
        self.count += 1


class QMoment(NamedTuple):
    """One blockwise-quantized moment: codes [nb, BLOCK] + fp32 scales [nb, 1]."""
    q: torch.Tensor
    scale: torch.Tensor


def _blocked(x: torch.Tensor) -> torch.Tensor:
    flat = x.reshape(-1).float()
    return torch.nn.functional.pad(flat, (0, (-flat.numel()) % BLOCK)).reshape(-1, BLOCK)


def _quant_signed(x: torch.Tensor) -> QMoment:
    xb = _blocked(x)
    scale = torch.clamp(xb.abs().amax(dim=1, keepdim=True) / 127.0, min=1e-12)
    return QMoment(torch.round(xb / scale).to(torch.int8), scale)


def _quant_sqrt(x: torch.Tensor) -> QMoment:
    """Non-negative moment, quantized in the sqrt domain (uint8 codes)."""
    sb = torch.sqrt(_blocked(x))
    scale = torch.clamp(sb.amax(dim=1, keepdim=True) / 255.0, min=1e-12)
    return QMoment(torch.round(sb / scale).to(torch.uint8), scale)


class ChainAdamW(_AdamWBase):
    """optax.chain(clip_by_global_norm(clip), adamw(schedule, b1, b2, eps,
    weight_decay, mask)) with fp32 moments (``state_dtype="fp32"``), or the
    JAX package's adamw_q with the moments carried as bf16 (``"bf16"``) or
    as blockwise int8 (``"int8"``) between steps, leaves under
    MIN_QUANT_SIZE in fp32. The update arithmetic is fp32, in each leaf's
    JAX-layout view, whose flatten gives the int8 blocks."""

    def __init__(self, schedule, b1, b2, eps, weight_decay, clip, state_dtype: str = "fp32"):
        if state_dtype not in ("fp32", "bf16", "int8"):
            raise ValueError(f"state_dtype must be fp32|bf16|int8, got {state_dtype!r}")
        super().__init__(schedule, b1, b2, eps, weight_decay, clip)
        self.state_dtype = state_dtype

    def _init_leaf(self, p):
        z = torch.zeros_like(p, dtype=torch.float32)
        return Fp32Leaf(self._compress(z, True), self._compress(z.clone(), False))

    def _compress(self, x: torch.Tensor, signed: bool):
        """A moment as carried: fp32, bf16 or a QMoment."""
        if self.state_dtype == "fp32" or x.numel() < MIN_QUANT_SIZE:
            return x
        if self.state_dtype == "bf16":
            return x.to(torch.bfloat16)
        return _quant_signed(x) if signed else _quant_sqrt(x)

    @staticmethod
    def _expand(m, shape, signed: bool) -> torch.Tensor:
        if not isinstance(m, QMoment):
            return m.float().reshape(shape)
        x = m.q.float() * m.scale
        n = math.prod(shape)
        return (x if signed else x * x).reshape(-1)[:n].reshape(shape)

    @torch.no_grad()
    def step(self) -> None:
        live = self._live()
        if not live:
            return
        grads = {i: self.params[i].grad.float() for i in live}
        dev = self.params[live[0]].device
        gnorm = _global_norm(list(grads.values()))
        lr, c1, c2 = self._host_to(dev).unbind()
        clipped = gnorm >= self.clip
        b1, b2, eps = self.b1, self.b2, self.eps
        for i in live:
            perm, m = self.layouts[i], self.moments[i]
            g = torch.where(clipped, (grads[i] / gnorm) * self.clip, grads[i]).permute(perm)
            pv = self.params[i].data.permute(perm)
            mu = b1 * self._expand(m.mu, g.shape, True) + (1.0 - b1) * g
            nu = b2 * self._expand(m.nu, g.shape, False) + (1.0 - b2) * g * g
            u = (mu / c1) / (torch.sqrt(nu / c2) + eps)
            if self.decay[i]:
                u = u + self.weight_decay * pv
            pv.copy_(pv + u * -lr)
            self.moments[i] = Fp32Leaf(self._compress(mu, True), self._compress(nu, False))
        self.count += 1

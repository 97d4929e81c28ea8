"""AdamW for the training step: the fused bf16-moment optimizer (kernel K5)
and the fp32 optax-chain optimizer, in PyTorch.

``FusedAdamW`` is the counterpart of vista_slam_tpu/train/
quantized_opt.py::make_fused_adamw with ``state_dtype="bf16_fused"``: one
step is clip-by-global-norm -> AdamW(b1, b2) with bias correction -> masked
weight decay -> lr from the schedule, applied in place. Leaves with at least
``MIN_QUANT_SIZE`` elements and a multiple of ``QBLOCK`` keep bf16 moments
[C, QBLOCK] and go through kernel K5 (kernels/adamw.py); the others keep fp32
moments and take the same math in plain PyTorch. bf16 moments are
elementwise, so flattening a parameter in torch order rather than in the
JAX package's layout changes nothing. (The int8 mode's per-1024-element
scales would depend on that order: the int8 slice has to flatten in the
JAX layout or accept other blocks.)

``Fp32AdamW`` is ``optax.chain(clip_by_global_norm(clip), adamw(...))`` with
fp32 moments, the JAX package's ``state_dtype="fp32"``, in plain PyTorch.

Both read the gradients from ``.grad`` and skip parameters without one.
The weight-decay mask is given per parameter (``decay``); the training
step takes it from the JAX-layout rank of each parameter
(models/convert.py::jax_param_ndims), as the JAX package decays leaves with
``ndim > 1``. The step count lives on the host; the four step scalars
(clip coefficient, lr, 1 - b1^t, 1 - b2^t) are one fp32 device tensor,
the clip coefficient computed on the device, so a step never waits for the
gradient norm.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from ..kernels.adamw import fused_adamw_bf16

QBLOCK = 1024        # K5's leaf view [C, QBLOCK], as adam8.py's
MIN_QUANT_SIZE = 2048


def fused_eligible(p: torch.Tensor) -> bool:
    return p.numel() >= MIN_QUANT_SIZE and p.numel() % QBLOCK == 0


class FusedBf16Leaf(NamedTuple):
    mu: torch.Tensor  # bf16 [C, QBLOCK]
    nu: torch.Tensor  # bf16 [C, QBLOCK]


class Fp32Leaf(NamedTuple):
    mu: torch.Tensor  # fp32, the parameter's shape
    nu: torch.Tensor


def _global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(g.float() * g.float()) for g in grads))


class _AdamWBase:
    def __init__(self, schedule: Callable[[int], np.float32], b1: float, b2: float,
                 eps: float, weight_decay: float, clip: float):
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.clip = weight_decay, clip
        self.count = 0
        self.params: list[torch.Tensor] = []
        self.decay: list[bool] = []
        self.moments: list = []

    def init(self, params: Sequence[torch.Tensor], decay: Sequence[bool]) -> None:
        """Bind to ``params`` (updated in place by ``step``); ``decay[i]``
        says whether params[i] takes weight decay."""
        if len(params) != len(decay):
            raise ValueError(f"{len(params)} params but {len(decay)} decay flags")
        self.params, self.decay = list(params), [bool(d) for d in decay]
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

    def _live(self):
        return [(p, m, d) for p, m, d in zip(self.params, self.moments, self.decay)
                if p.grad is not None]


class FusedAdamW(_AdamWBase):
    """The fused bf16-moment AdamW (``state_dtype="bf16_fused"``)."""

    def _init_leaf(self, p):
        if not fused_eligible(p):
            return super()._init_leaf(p)
        C = p.numel() // QBLOCK
        return FusedBf16Leaf(torch.zeros((C, QBLOCK), dtype=torch.bfloat16, device=p.device),
                             torch.zeros((C, QBLOCK), dtype=torch.bfloat16, device=p.device))

    @torch.no_grad()
    def step(self) -> None:
        live = self._live()
        if not live:
            return
        grads = [p.grad.contiguous() for p, _, _ in live]
        dev = live[0][0].device
        gnorm = _global_norm(grads)
        coef = self.clip / torch.clamp(gnorm, min=self.clip)  # = min(1, clip/||g||)
        scalars = torch.cat([coef.reshape(1), self._host_to(dev)])
        _, lr, c1, c2 = scalars.unbind()
        b1, b2, eps = self.b1, self.b2, self.eps
        for (p, m, decays), g in zip(live, grads):
            wd = self.weight_decay if decays else 0.0
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


class Fp32AdamW(_AdamWBase):
    """optax.chain(clip_by_global_norm(clip), adamw(schedule, b1, b2, eps,
    weight_decay, mask)) with fp32 moments (``state_dtype="fp32"``)."""

    @torch.no_grad()
    def step(self) -> None:
        live = self._live()
        if not live:
            return
        grads = [p.grad.float() for p, _, _ in live]
        dev = live[0][0].device
        gnorm = _global_norm(grads)
        lr, c1, c2 = self._host_to(dev).unbind()
        clipped = gnorm >= self.clip
        b1, b2, eps = self.b1, self.b2, self.eps
        for (p, m, decays), g in zip(live, grads):
            g = torch.where(clipped, (g / gnorm) * self.clip, g)
            m.mu.copy_((1 - b1) * g + b1 * m.mu)
            m.nu.copy_((1 - b2) * (g * g) + b2 * m.nu)
            u = (m.mu / c1) / (torch.sqrt(m.nu / c2) + eps)
            if decays:
                u = u + self.weight_decay * p
            p.copy_(p + u * -lr)
        self.count += 1


"""The training step for the STA frontend, in PyTorch.

The counterpart of vista_slam_tpu/train/step.py (reference:
vista_slam/sta_model/train.py:233-328): forward (bf16 compute over fp32
parameters) -> loss -> ``backward()`` -> global-norm clip + AdamW, as a
plain eager function on tensors. The optimizer follows the JAX package's
``make_optimizer``: AdamW(0.9, 0.95) with a per-iteration warm-up + cosine
schedule, weight decay on parameters whose JAX-layout rank is above 1, and
moments in fp32 (``state_dtype="fp32"``), in bf16 through kernel K5
(``"bf16_fused"``), in int8 through kernel K4 (``"int8_fused"``), or
carried compressed between plain-PyTorch steps (``"bf16"``, ``"int8"``),
with gradient accumulation (``accum_iter``, optax.MultiSteps) and frozen
parameters (``freeze``) on the unfused modes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..models.convert import jax_layouts, jax_param_ndims
from ..models.sta import STA
from .losses import sta_criterion
from .quantized_opt import ChainAdamW, FusedAdamW, MultiSteps


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0):
    """optax.warmup_cosine_decay_schedule, evaluated in float32 as optax
    evaluates it: a linear warm-up from init_value to peak_value over
    warmup_steps, then a cosine decay to end_value at decay_steps."""
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if warmup_steps <= 0 or cos_steps <= 0:
        raise ValueError(f"need 0 < warmup_steps < decay_steps, got "
                         f"{warmup_steps}, {decay_steps}")

    def schedule(count: int) -> np.float32:
        if count < warmup_steps:
            frac = f32(1) - f32(min(max(count, 0), warmup_steps)) / f32(warmup_steps)
            return f32(init_value - peak_value) * frac + f32(peak_value)
        c = f32(min(count - warmup_steps, cos_steps))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(cos_steps)))
        return f32(peak_value) * (f32(1 - alpha) * cosine + f32(alpha))

    return schedule


def make_optimizer(lr: float = 1e-4, warmup_steps: int = 1000,
                   total_steps: int = 100_000, min_lr: float = 1e-6,
                   weight_decay: float = 0.05, clip: float = 1.0,
                   accum_iter: int = 1, freeze=None, state_dtype: str = "fp32"):
    """AdamW(0.9, 0.95) + per-iteration cosine schedule with warm-up +
    global-norm clip (reference: train.py:403-404, croco_misc.py:454-469,
    clip at train.py:293). ``state_dtype``: fp32, bf16_fused, int8_fused,
    bf16 or int8 (train/quantized_opt.py). ``accum_iter`` > 1 averages the
    gradients of that many mini-steps before each update (reference:
    train.py:142-143,292-297); ``freeze`` is a predicate(name_path) -> bool
    over each parameter's name split at the dots, marking the parameters
    that ``bind_optimizer`` freezes (reference set_freeze,
    sta_model.py:148-161). Bind it to parameters with ``bind_optimizer``
    (or ``init``)."""
    if state_dtype.endswith("_fused") and (accum_iter > 1 or freeze is not None):
        raise ValueError("the fused optimizer kernel does not compose "
                         "with accum_iter/freeze; use state_dtype="
                         "'int8'/'bf16' (XLA carriers) for those")
    warmup_steps = min(warmup_steps, max(total_steps // 10, 1))
    schedule = warmup_cosine_decay_schedule(0.0, lr, warmup_steps, total_steps, min_lr)
    hp = (schedule, 0.9, 0.95, 1e-8, weight_decay, clip)
    if state_dtype in ("bf16_fused", "int8_fused"):
        return FusedAdamW(*hp, state_dtype=state_dtype)
    if state_dtype not in ("fp32", "bf16", "int8"):
        raise ValueError(f"unknown state_dtype {state_dtype!r}")
    opt = ChainAdamW(*hp, state_dtype=state_dtype)
    if accum_iter > 1:
        opt = MultiSteps(opt, accum_iter)
    opt.freeze = freeze
    return opt


def freeze_encoder(path: tuple[str, ...]) -> bool:
    """Freeze predicate matching the reference's freeze='encoder' (patch
    embed + encoder blocks, sta_model.py:150-152). The JAX package's names
    ``enc_block{i}``/``patch_embed`` are the port's ``enc_blocks.{i}``/
    ``patch_embed.proj`` (models/convert.py), so the one test of the JAX
    package's predicate picks the same parameters from either."""
    return any(n.startswith(("enc_block", "patch_embed")) for n in path)


def bind_optimizer(model: torch.nn.Module, optimizer) -> list[torch.Tensor]:
    """Freeze the parameters that ``optimizer.freeze`` marks
    (``requires_grad_(False)``: no gradient, so no update and no share of
    the clip's global norm, as under the JAX package's multi_transform) and
    bind ``optimizer`` to every parameter, with the weight-decay flag and
    JAX-layout permutation of each (models/convert.py). Returns the
    parameters in ``named_parameters`` order."""
    names, params = zip(*model.named_parameters())
    if optimizer.freeze is not None:
        for n, p in zip(names, params):
            if optimizer.freeze(tuple(n.split("."))):
                p.requires_grad_(False)
    ndims, layouts = jax_param_ndims(model), jax_layouts(model)
    optimizer.init(params, [ndims[n] > 1 for n in names], [layouts[n] for n in names])
    return list(params)


def split_train_outputs(out: dict, n_support: int, batch: int):
    """Slice the train_forward output (leading 2*S*B) into per-support
    main/support prediction dicts."""
    SB = n_support * batch
    keys = ("pts3d", "conf", "pose", "pose_conf")
    mains = [{k: out[k][i * batch:(i + 1) * batch] for k in keys} for i in range(n_support)]
    supports = [{k: out[k][SB + i * batch:SB + (i + 1) * batch] for k in keys}
                for i in range(n_support)]
    return mains, supports


def make_loss_fn(model: STA, n_support: int):
    """loss_fn(batch, conf_alpha) -> (loss, details) over a batch of tensors
    in train_step's layout (train/data.py::collate_graphs)."""
    def loss_fn(batch: dict, conf_alpha: float = 0.4):
        out = model.train_forward(batch["main"]["img"], batch["support_imgs"])
        B = batch["main"]["img"].shape[0]
        mains, supports = split_train_outputs(out, n_support, B)
        gt_supports = [{k: v[i] for k, v in batch["supports"].items()}
                       for i in range(n_support)]
        return sta_criterion(batch["main"], gt_supports, mains, supports,
                             conf_alpha=conf_alpha)

    return loss_fn


def batch_to(batch: dict, device) -> dict:
    """The collated numpy batch as tensors on ``device``."""
    if isinstance(batch, dict):
        return {k: batch_to(v, device) for k, v in batch.items()}
    return torch.as_tensor(np.asarray(batch)).to(device, non_blocking=True)


def make_train_step(model: STA, optimizer, n_support: int, device="cuda"):
    """Move ``model`` to ``device``, bind ``optimizer`` to its parameters
    (``bind_optimizer``: frozen parameters, weight decay where the
    JAX-layout rank is above 1, blocks of the int8 modes in the JAX
    layout) and return
    ``step_fn(batch, conf_alpha=0.4) -> (loss, details)``: one eager
    forward, ``backward()`` and optimizer step on a collated numpy batch.
    The loss comes back as a device tensor (no host sync)."""
    device = torch.device(device)
    model.to(device).train()
    params = bind_optimizer(model, optimizer)
    loss_fn = make_loss_fn(model, n_support)

    def step_fn(batch: dict, conf_alpha: float = 0.4):
        for p in params:
            p.grad = None
        loss, details = loss_fn(batch_to(batch, device), conf_alpha)
        loss.backward()
        optimizer.step()
        return loss.detach(), {k: v.detach() for k, v in details.items()}

    return step_fn

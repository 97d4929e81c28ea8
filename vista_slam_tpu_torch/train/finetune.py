"""Full-width training presets of the STA frontend, on synthetic data.

Presets (``PRESETS``), all with configs/train_fast.yaml's
hyper-parameters and model setting (``gelu_approx``), the full 24x1024
encoder and 12x768 decoder with DPT and pose heads, bf16 compute over fp32
parameters and 3 supports:
  * ``"highres"``: the 384x512 fine-tune, configs/highres.yaml's model
    (769 tokens, flash attention: kernels K1, K2a, K2b) with bf16-moment
    AdamW (K5), batch 2;
  * ``"memory_knob"``: train_fast.yaml's own 224x224 model (STAConfig
    defaults, 196/197 tokens) at its batch size 8 with the JAX package's two
    training memory knobs (docs/PERFORMANCE.md): ``attn_fused_train``
    (kernels K3a, K3b) and int8-moment AdamW (``int8_fused``, K4).
    ``build(preset="memory_knob", attn_fused_train=False,
    state_dtype="bf16")`` is train_fast.yaml as written (plain attention,
    bf16 moments carried between plain-PyTorch steps).
The data is the synthetic box scene, driven the way the JAX package's
scripts/train_synthetic.py drives training: TrainLoader over
SyntheticSceneDataset -> make_optimizer -> make_train_step. The settings
are inlined so that the run needs no YAML parser; tests/test_torch_train.py
and tests/test_torch_train_fast.py hold them equal to the files.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..datasets.synthetic_scene import SyntheticSceneDataset
from ..models.sta import STA, STAConfig
from .data import TrainLoader
from .step import make_optimizer, make_train_step

MODEL = {"img_size": (384, 512), "use_flash": True}  # configs/highres.yaml
TRAIN = {"lr": 1.5e-5, "min_lr": 1.0e-6, "weight_decay": 0.05, "clip": 1.0,
         "epochs": 200, "warmup_epochs": 10, "neighbor_num": 1, "loop_num": 1,
         "alpha_init": 0.4, "model": {"gelu_approx": True}}  # configs/train_fast.yaml
STATE_DTYPE = "bf16_fused"
BATCH = 2
N_FRAMES = 64  # views of the synthetic scene: 32 steps per epoch at BATCH
SEED = 43      # configs/highres.yaml's random_seed


class Preset(NamedTuple):
    model: dict        # STAConfig fields beside train_fast.yaml's model section
    state_dtype: str   # the optimizer's moment storage
    batch: int


PRESETS = {
    "highres": Preset(MODEL, STATE_DTYPE, BATCH),
    # train_fast.yaml's model (STAConfig defaults: 224x224, use_flash None)
    # and batch_size, with both memory knobs
    "memory_knob": Preset({"img_size": (224, 224), "use_flash": None,
                           "attn_fused_train": True}, "int8_fused", 8),
}


def model_config(preset: str = "highres", **overrides) -> STAConfig:
    """The preset's model with train_fast.yaml's model setting, bf16
    compute over fp32 parameters; ``overrides`` replace any field."""
    kw = dict(PRESETS[preset].model, compute_dtype=torch.bfloat16,
              param_dtype=torch.float32, **TRAIN["model"])
    kw.update(overrides)
    return STAConfig(**kw)


def n_support() -> int:
    """2 * neighbor_num neighbours + loop_num loop views (S = 3)."""
    return 2 * TRAIN["neighbor_num"] + TRAIN["loop_num"]


def optimizer(lr: float = TRAIN["lr"], warmup_steps: int | None = None,
              total_steps: int | None = None, preset: str = "highres",
              state_dtype: str | None = None, batch: int | None = None):
    """train_fast.yaml's clipped AdamW with the preset's moments (or
    ``state_dtype``); the warm-up and the length default to its epochs over
    N_FRAMES views at the preset's batch (or ``batch``)."""
    per_epoch = N_FRAMES // (batch or PRESETS[preset].batch)
    return make_optimizer(
        lr=lr, warmup_steps=warmup_steps or TRAIN["warmup_epochs"] * per_epoch,
        total_steps=total_steps or TRAIN["epochs"] * per_epoch,
        min_lr=TRAIN["min_lr"], weight_decay=TRAIN["weight_decay"],
        clip=TRAIN["clip"], state_dtype=state_dtype or PRESETS[preset].state_dtype)


def batches(hw, n: int, batch: int = BATCH, seed: int = 0) -> list:
    """The first ``n`` collated batches of epoch 0 of a TrainLoader over
    the synthetic box scene rendered at ``hw`` (focal 0.75 W, the JAX
    package's synthetic-training field of view)."""
    ds = SyntheticSceneDataset(n_frames=N_FRAMES, hw=hw, focal=0.75 * hw[1], seed=seed,
                               neighbor_num=TRAIN["neighbor_num"],
                               loop_num=TRAIN["loop_num"])
    loader = TrainLoader(ds, batch, n_support())
    loader.set_epoch(0)
    out = []
    for b in loader:
        out.append(b)
        if len(out) == n:
            return out
    raise ValueError(f"the loader gave {len(out)} < {n} batches")


def build(device="cuda", seed: int = SEED, preset: str = "highres",
          state_dtype: str | None = None, batch: int | None = None, **overrides):
    """The preset's full-width model (``overrides`` replace STAConfig
    fields) with random weights from a seeded ``torch.Generator``, on
    ``device``, its optimizer (``state_dtype`` and ``batch`` as in
    ``optimizer``) and its ``step_fn(batch, conf_alpha)``."""
    model = STA(model_config(preset, **overrides)).to(device)
    model.init_weights_(torch.Generator(device=device).manual_seed(seed))
    opt = optimizer(preset=preset, state_dtype=state_dtype, batch=batch)
    return model, opt, make_train_step(model, opt, n_support(), device=device)

"""The 384x512 fine-tune of the STA frontend, on synthetic data.

configs/highres.yaml's model (384x512, flash attention, the full 24x1024
encoder and 12x768 decoder, DPT head) trained with configs/train_fast.yaml's
hyper-parameters and bf16-moment AdamW (kernel K5), bf16 compute over fp32
parameters. The data is the synthetic box scene, driven the way the JAX
package's scripts/train_synthetic.py drives training: TrainLoader over
SyntheticSceneDataset -> make_optimizer -> make_train_step. The settings
are inlined so that the run needs no YAML parser; tests/test_torch_train.py
holds them equal to the two files.
"""

from __future__ import annotations

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


def model_config(**overrides) -> STAConfig:
    """highres.yaml's model with train_fast.yaml's model setting, bf16
    compute over fp32 parameters; ``overrides`` replace any field."""
    kw = dict(img_size=MODEL["img_size"], use_flash=MODEL["use_flash"],
              compute_dtype=torch.bfloat16, param_dtype=torch.float32, **TRAIN["model"])
    kw.update(overrides)
    return STAConfig(**kw)


def n_support() -> int:
    """2 * neighbor_num neighbours + loop_num loop views (S = 3)."""
    return 2 * TRAIN["neighbor_num"] + TRAIN["loop_num"]


def optimizer(lr: float = TRAIN["lr"], warmup_steps: int | None = None,
              total_steps: int | None = None):
    """train_fast.yaml's clipped AdamW with bf16 moments; the warm-up and
    the length default to its epochs over N_FRAMES views at BATCH."""
    per_epoch = N_FRAMES // BATCH
    return make_optimizer(
        lr=lr, warmup_steps=warmup_steps or TRAIN["warmup_epochs"] * per_epoch,
        total_steps=total_steps or TRAIN["epochs"] * per_epoch,
        min_lr=TRAIN["min_lr"], weight_decay=TRAIN["weight_decay"],
        clip=TRAIN["clip"], state_dtype=STATE_DTYPE)


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


def build(device="cuda", seed: int = SEED):
    """The full-width model with random weights from a seeded
    ``torch.Generator``, on ``device``, its optimizer and its
    ``step_fn(batch, conf_alpha)``."""
    model = STA(model_config()).to(device)
    model.init_weights_(torch.Generator(device=device).manual_seed(seed))
    opt = optimizer()
    return model, opt, make_train_step(model, opt, n_support(), device=device)

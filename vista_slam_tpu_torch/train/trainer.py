"""Training driver: epoch loop, metrics, checkpoint/resume.

The counterpart of vista_slam_tpu/train/trainer.py (reference:
vista_slam/sta_model/train.py:331-478 and utils/croco_misc.py):
  * per-iteration warmup+cosine LR, AdamW(0.9, 0.95), grad clip 1.0
  * per-epoch test evaluation with best-checkpoint tracking
  * coarse-to-fine confidence alpha schedule fed into the loss
    (train.py:466-468)
  * checkpoint-last / checkpoint-best with optimizer + epoch state
    (``torch.save``, the last 3 kept as the JAX package's orbax manager
    keeps them)
  * JSON-lines log.txt metrics, windowed MetricLogger smoothing, and
    TensorBoard scalars behind cfg.tensorboard (train.py:316-323,428-431)
One process on one device (``device=``, CUDA by default) in place of the
JAX package's mesh. Parameters are fp32 and compute bf16 unless the model
section says otherwise, as the JAX trainer holds them. The datasets come
from the config's spec strings, or ready-built through ``train_ds`` /
``test_ds`` (any dataset with the view-graph item layout, such as
datasets/synthetic_scene.py::SyntheticSceneDataset).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from ..models.sta import STA, STAConfig
from ..utils.logging import Channel, log
from .data import TrainLoader, build_dataset
from .metrics import MetricLogger, ScalarWriter
from .step import batch_to, make_loss_fn, make_optimizer, make_train_step

MAX_TO_KEEP = 3  # checkpoints kept per directory (orbax max_to_keep)


@dataclasses.dataclass
class TrainConfig:
    train_dataset: str = ""
    test_dataset: str = ""
    output_dir: str = "output/train"
    batch_size: int = 4
    epochs: int = 200
    steps_per_epoch: int | None = None  # derived from the dataset if None
    lr: float = 1.5e-5
    min_lr: float = 1e-6
    weight_decay: float = 0.05
    warmup_epochs: int = 10
    clip: float = 1.0
    neighbor_num: int = 1
    loop_num: int = 1
    alpha_c2f: bool = True  # coarse-to-fine conf alpha
    opt_state_dtype: str = "bf16"
    #   Adam moment storage: fp32 | bf16 | int8 | bf16_fused | int8_fused
    #   (train/quantized_opt.py; update math identical). bf16/int8 are the
    #   compressed carriers in plain PyTorch, *_fused the kernels K5/K4.
    #   The default is the JAX package's; resuming a checkpoint saved with
    #   another one raises.
    alpha_init: float = 0.4
    seed: int = 0
    save_freq: int = 1
    tensorboard: bool = False  # scalar event files under output_dir/tb
    log_every: int = 20        # windowed-metric console cadence (iterations)
    num_workers: int = 0       # loader threads (0 = synchronous)
    model: dict = dataclasses.field(default_factory=dict)

    @property
    def n_support(self) -> int:
        return 2 * self.neighbor_num + self.loop_num


def _alpha_schedule(cfg: TrainConfig, epoch: int) -> float:
    if not cfg.alpha_c2f:
        return cfg.alpha_init
    half = 0.5 * cfg.epochs
    return cfg.alpha_init - 0.2 * max((epoch - half) / max(half, 1), 0.0)


def model_config(overrides: dict) -> STAConfig:
    """STAConfig from a config's model section: fp32 parameters unless it
    says otherwise, dtypes by name ("bfloat16") or as torch dtypes."""
    kw = {"param_dtype": torch.float32, **overrides}
    if "img_size" in kw:
        kw["img_size"] = tuple(kw["img_size"])
    for k in ("compute_dtype", "param_dtype"):
        if isinstance(kw.get(k), str):
            kw[k] = getattr(torch, kw[k])
    return STAConfig(**kw)


class Trainer:
    def __init__(self, cfg: TrainConfig, device="cuda", train_ds=None, test_ds=None):
        self.cfg = cfg
        self.device = torch.device(device)
        self.model_cfg = model_config(cfg.model)
        self.model = STA(self.model_cfg).to(self.device)
        os.makedirs(cfg.output_dir, exist_ok=True)

        self.train_ds = train_ds if train_ds is not None else build_dataset(cfg.train_dataset)
        self.test_ds = test_ds if test_ds is not None else (
            build_dataset(cfg.test_dataset) if cfg.test_dataset else None)
        self.loader = TrainLoader(self.train_ds, cfg.batch_size, cfg.n_support,
                                  num_workers=cfg.num_workers)
        steps = cfg.steps_per_epoch or max(len(self.loader), 1)
        self.optimizer = make_optimizer(
            lr=cfg.lr, warmup_steps=cfg.warmup_epochs * steps,
            total_steps=steps * cfg.epochs, min_lr=cfg.min_lr,
            weight_decay=cfg.weight_decay, clip=cfg.clip,
            state_dtype=cfg.opt_state_dtype)
        self.eval_loss_fn = make_loss_fn(self.model, cfg.n_support)
        self.step_fn = None  # bound by init_state
        self.step = 0        # train steps taken (resumed from a checkpoint)
        self.start_epoch = 0
        self.best_so_far = float("inf")
        self.best_epoch = -1
        self.writer = ScalarWriter(os.path.join(cfg.output_dir, "tb"),
                                   enabled=cfg.tensorboard)

    # -- checkpointing (torch.save) ------------------------------------------
    def _ckpt_dir(self, name: str = "checkpoints") -> str:
        return os.path.join(self.cfg.output_dir, name)

    @staticmethod
    def _epochs_saved(path: str) -> list[int]:
        if not os.path.isdir(path):
            return []
        return sorted(int(f[:-3]) for f in os.listdir(path)
                      if f.endswith(".pt") and f[:-3].isdigit())

    def save_checkpoint(self, epoch: int, best: float, name: str = "checkpoints") -> str:
        """``<output_dir>/<name>/<epoch>.pt``: the model's and the optimizer's
        state dicts, ``step`` and ``meta = [epoch, best]``; the last
        MAX_TO_KEEP epochs stay. Returns the file's path."""
        path = self._ckpt_dir(name)
        os.makedirs(path, exist_ok=True)
        payload = {"model": self.model.state_dict(),
                   "optimizer": self.optimizer.state_dict(),
                   "step": self.step, "meta": [int(epoch), float(best)]}
        out = os.path.join(path, f"{epoch}.pt")
        torch.save(payload, out + ".tmp")
        os.replace(out + ".tmp", out)
        for old in self._epochs_saved(path)[:-MAX_TO_KEEP]:
            os.remove(os.path.join(path, f"{old}.pt"))
        return out

    def restore_checkpoint(self) -> bool:
        """Load the latest checkpoint in place (the model's and the
        optimizer's tensors keep their storage, which the int8_fused
        optimizer's kernel table points at); resume at the epoch after it.
        An optimizer state saved with another ``opt_state_dtype`` raises."""
        path = self._ckpt_dir()
        saved = self._epochs_saved(path)
        if not saved:
            return False
        payload = torch.load(os.path.join(path, f"{saved[-1]}.pt"), map_location="cpu",
                             weights_only=True)
        self.optimizer.load_state_dict(payload["optimizer"])
        self.model.load_state_dict(payload["model"])
        self.step = int(payload["step"])
        self.start_epoch = int(payload["meta"][0]) + 1
        self.best_so_far = float(payload["meta"][1])
        log(f"resumed from epoch {self.start_epoch}", Channel.INFO)
        return True

    # -- loops ---------------------------------------------------------------
    def init_state(self, params: dict | None = None, resume: bool = True):
        """Random weights from ``cfg.seed`` (or the state dict ``params``,
        loaded in place), the optimizer bound to them, then the latest
        checkpoint if ``resume``."""
        if params is None:
            self.model.init_weights_(
                torch.Generator(device=self.device).manual_seed(self.cfg.seed))
        else:
            self.model.load_state_dict(params)
        self.step_fn = make_train_step(self.model, self.optimizer, self.cfg.n_support,
                                       device=self.device)
        self.step = 0
        if resume:
            self.restore_checkpoint()

    def train_one_epoch(self, epoch: int) -> dict:
        self.loader.set_epoch(epoch)
        alpha = _alpha_schedule(self.cfg, epoch)
        meters = MetricLogger(window_size=self.cfg.log_every)
        losses = []
        t0 = time.time()
        for i, batch in enumerate(self.loader):
            it0 = time.time()
            loss, details = self.step_fn(batch, alpha)
            loss = float(loss)
            self.step += 1
            if not np.isfinite(loss):
                # abort with diagnostics (reference: train.py:287-290)
                raise FloatingPointError(
                    f"non-finite loss at epoch {epoch} step {i}: "
                    f"{ {k: float(v) for k, v in details.items()} }")
            losses.append(loss)
            meters.update(loss=loss, iter_s=time.time() - it0)
            if self.cfg.tensorboard:
                self.writer.add_scalar("train/loss_iter", loss, self.step)
            if (i + 1) % self.cfg.log_every == 0:
                log(f"epoch {epoch} it {i + 1}: {meters.summary()}", Channel.INFO)
        return {"loss": float(np.mean(losses)) if losses else float("nan"),
                "loss_median": meters.loss.median if losses else float("nan"),
                "steps": len(losses), "time_s": time.time() - t0}

    def test_one_epoch(self, epoch: int) -> dict:
        """The loss at the default alpha over the test set, forward only."""
        if self.test_ds is None:
            return {}
        loader = TrainLoader(self.test_ds, self.cfg.batch_size, self.cfg.n_support,
                             num_workers=self.cfg.num_workers)
        loader.set_epoch(epoch)
        losses = []
        with torch.no_grad():
            for batch in loader:
                loss, _ = self.eval_loss_fn(batch_to(batch, self.device))
                losses.append(float(loss))
        return {"test_loss": float(np.mean(losses)) if losses else float("nan")}

    def _write_log(self, epoch: int, stats: dict):
        with open(os.path.join(self.cfg.output_dir, "log.txt"), "a") as f:
            f.write(json.dumps({"epoch": epoch, **stats}) + "\n")

    def fit(self) -> STA:
        if self.step_fn is None:
            self.init_state()
        for epoch in range(self.start_epoch, self.cfg.epochs):
            alpha = _alpha_schedule(self.cfg, epoch)
            train_stats = self.train_one_epoch(epoch)
            test_stats = self.test_one_epoch(epoch)
            stats = {**train_stats, **test_stats, "alpha": alpha}
            log(f"epoch {epoch}: {stats}", Channel.INFO)
            self._write_log(epoch, stats)
            if self.cfg.tensorboard:
                for k, v in stats.items():
                    if np.isscalar(v) and np.isfinite(v):
                        self.writer.add_scalar(f"epoch/{k}", float(v), epoch)
                self.writer.flush()
            metric = test_stats.get("test_loss", train_stats["loss"])
            if np.isfinite(metric) and metric < self.best_so_far:
                self.best_so_far = metric
                self.best_epoch = epoch
                # separate best checkpoint (reference: croco_misc.py:297-310
                # checkpoint-best)
                self.save_checkpoint(epoch, self.best_so_far, name="checkpoints_best")
            if epoch % self.cfg.save_freq == 0:
                self.save_checkpoint(epoch, self.best_so_far)
        self.writer.close()
        return self.model

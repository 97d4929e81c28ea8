"""Training entry point of the port (the counterpart of
vista_slam_tpu/cli/train.py).

Usage:
  python -m vista_slam_tpu_torch.cli.train --config configs/train_fast.yaml \
      [--resume] [--output DIR] [--device cuda|cpu]

The config is YAML with TrainConfig fields; dataset specs use the composable
registry syntax, e.g.:
  train_dataset: >
    10000 @ ScanNet(sensor_data_root='/data/scannet', view_graph_root='/data/vg',
                    split='train', resolution=(224, 224), neighbor_num=1, loop_num=1)
(reference CLI: train.py + sta_model/train.py:68-175, with eval()-based specs
replaced by a safe parser.)

Optimizer-state compression: `opt_state_dtype: fp32|bf16|int8|bf16_fused|
int8_fused` selects the Adam moment storage (train/quantized_opt.py). The
*_fused modes run the kernels K5 (bf16) and K4 (int8); they reject gradient
accumulation and parameter freezing at construction time with a ValueError
naming the fallback (use bf16/int8 there).
"""

from __future__ import annotations

import argparse
import dataclasses

from ..train.trainer import TrainConfig, Trainer
from ..utils.logging import log


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", required=True)
    ap.add_argument("--output", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    import yaml

    with open(args.config) as f:
        raw = yaml.safe_load(f) or {}
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    unknown = set(raw) - fields
    if unknown:
        raise SystemExit(f"unknown config keys: {sorted(unknown)}")
    if args.output:
        raw["output_dir"] = args.output
    cfg = TrainConfig(**raw)

    trainer = Trainer(cfg, device=args.device)
    trainer.init_state(resume=args.resume)
    log(f"training on {trainer.device} — {len(trainer.loader)} steps/epoch, "
        f"{cfg.epochs} epochs")
    trainer.fit()
    return trainer


if __name__ == "__main__":
    main()

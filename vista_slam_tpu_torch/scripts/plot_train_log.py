"""Plot training curves from the JSONL log that the port's trainer writes
(train/trainer.py -> <output_dir>/log.txt; the port of
scripts/plot_train_log.py). Needs matplotlib.

Usage:
  python -m vista_slam_tpu_torch.scripts.plot_train_log --log output/train/log.txt
"""

from __future__ import annotations

import argparse
import json

from ..utils.optional import require


def main(argv=None):
    matplotlib = require("matplotlib", "matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ap = argparse.ArgumentParser()
    ap.add_argument("--log", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    with open(args.log) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    epochs = [r["epoch"] for r in rows]
    fig, axes = plt.subplots(1, 2, figsize=(12, 4))
    axes[0].plot(epochs, [r.get("loss") for r in rows], label="train")
    if any("test_loss" in r for r in rows):
        axes[0].plot(epochs, [r.get("test_loss") for r in rows], label="test")
    axes[0].set_xlabel("epoch")
    axes[0].set_ylabel("loss")
    axes[0].legend()
    axes[1].plot(epochs, [r.get("alpha") for r in rows])
    axes[1].set_xlabel("epoch")
    axes[1].set_ylabel("conf alpha (coarse-to-fine)")
    out = args.out or args.log.rsplit("/", 1)[0] + "/train_curves.png"
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()

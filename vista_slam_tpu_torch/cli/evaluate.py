"""Dataset evaluation entry point of the port: run SLAM on GT sequences, report
ATE (and optionally dense-reconstruction chamfer); the loop of
vista_slam_tpu/cli/evaluate.py.

One entry point covers all five reference scripts (reference:
evaluation_tumrgbd.py, evaluation_tumrgbdf2f3.py, evaluation_7scenes.py,
evaluation_replica.py, evaluation_scannet.py): stride-subsampled keyframes
capped at max_view_num, per-scene SLAM run, artifact dump with GT, Sim(3)
ATE, optional chamfer.

Usage:
  python -m vista_slam_tpu_torch.cli.evaluate --dataset tumrgbd \
      --data-root /data/tum --config configs/tumrgbd.yaml [--scenes floor xyz]
      [--recon]

``evaluate_scene`` takes any indexable dataset of the loaders' dicts (with
GT), so it runs from in-memory frames; yaml and the file loaders are
imported in ``main``. One model serves every scene.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..eval.recon import eval_recon_from_saved_data
from ..eval.traj import full_traj_eval
from ..utils.logging import Channel, log
from .common import build_frontend, build_slam

DATASETS = {
    "tumrgbd": dict(
        cls="SLAMTUMRGBD",
        scenes=["360", "desk", "desk2", "floor", "plant", "room", "rpy",
                "teddy", "xyz"],
        path="rgbd_dataset_freiburg1_{scene}",
        recon=False,
    ),
    "tumrgbd_f2f3": dict(
        cls="SLAMTUMRGBD",
        scenes=["freiburg2_desk", "freiburg2_xyz", "freiburg3_long_office_household"],
        path="rgbd_dataset_{scene}",
        recon=False,
    ),
    "7scenes": dict(
        cls="SLAMSevenScenes",
        scenes=["chess", "fire", "heads", "office", "pumpkin", "redkitchen",
                "stairs"],
        path="{scene}/seq-01",
        recon=True,
    ),
    "replica": dict(
        cls="SLAMReplica",
        scenes=["office0", "office1", "office2", "office3", "office4",
                "room0", "room1", "room2"],
        path="{scene}",
        recon=True,
    ),
    "scannet": dict(
        cls="SLAMScanNet",
        scenes=["scene0000_00", "scene0059_00", "scene0106_00", "scene0169_00",
                "scene0181_00", "scene0207_00"],
        path="{scene}",
        recon=True,
    ),
}


def evaluate_scene(slam, dataset, cfg, out_dir: str, do_recon: bool):
    n = len(dataset)
    inputs = list(range(1, n, cfg.stride))
    if len(inputs) > cfg.max_view_num:
        inputs = list(np.linspace(0, n - 1, cfg.max_view_num).astype(int))

    gt_poses, gt_depths = [], []
    K = None
    # keyframes are known upfront: read + batch-encode a chunk ahead (the
    # reference encodes serially, slam.py:142-151)
    chunk = 8
    batched = hasattr(slam.frontend, "encode_batch")
    for c0 in range(0, len(inputs), chunk):
        ts = inputs[c0:c0 + chunk]
        datas = [dataset[int(t)] for t in ts]
        feats = (slam.frontend.encode_batch(
            np.stack([d["rgb"] for d in datas])) if batched
            else [None] * len(datas))
        for k, (data, feat) in enumerate(zip(datas, feats)):
            gt_poses.append(data["camera_pose"])
            gt_depths.append(data["depth"])
            K = data["intrinsic"]
            slam.step({"rgb": data["rgb"], "gray": data["gray"],
                       "view_name": data["img_name"], "enc_feat": feat},
                      force_pgo=(c0 + k == len(inputs) - 1))

    est_poses = [slam.get_view(v, filter_outlier=False)["pose"]
                 for v in range(slam.view_num)]
    slam.save_data_all(out_dir, gt_poses=gt_poses, gt_depths=gt_depths,
                       gt_intrinsics=K)

    log("evaluating trajectory ...", Channel.EVAL)
    stats = full_traj_eval(est_poses, gt_poses, out_dir, "traj")
    result = {"ate_rmse": stats["rmse"], "ate_mean": stats["mean"],
              "n_keyframes": slam.view_num}
    if do_recon:
        log("evaluating reconstruction ...", Channel.EVAL)
        R, t, s = stats["alignment"]
        acc, comp, chamfer, _, _ = eval_recon_from_saved_data(
            out_dir, rel_est_gt=[R, t, s])
        result.update({"recon_acc": acc, "recon_comp": comp,
                       "recon_chamfer": chamfer})
    with open(os.path.join(out_dir, "evaluation_results.json"), "w") as f:
        json.dump(result, f, indent=2)
    log(f"scene results: {result}", Channel.EVAL)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dataset", required=True, choices=sorted(DATASETS))
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--config", required=True)
    ap.add_argument("--scenes", nargs="*", default=None)
    ap.add_argument("--recon", action="store_true",
                    help="force dense reconstruction eval")
    ap.add_argument("--output", default=None)
    args = ap.parse_args(argv)

    import torch

    from ..datasets import slam_sequences
    from ..utils.config import load_config

    # full fp32 in fp32 matmuls and convolutions (the heads' numerics)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = DATASETS[args.dataset]
    ds_cls = getattr(slam_sequences, spec["cls"])
    scenes = args.scenes or spec["scenes"]
    cfg = load_config(args.config, output_dir=args.output)
    os.makedirs(cfg.output_dir, exist_ok=True)
    do_recon = args.recon or spec["recon"]

    res = tuple((cfg.get("model", {}) or {}).get("img_size", (224, 224)))
    frontend = build_frontend(cfg)
    results = {}
    for scene in scenes:
        path = os.path.join(args.data_root, spec["path"].format(scene=scene))
        dataset = ds_cls(path, resolution=res)
        slam = build_slam(cfg, frontend=frontend)
        out_dir = os.path.join(cfg.output_dir, f"{args.dataset}_{scene}")
        results[scene] = evaluate_scene(slam, dataset, cfg, out_dir, do_recon)

    avg = float(np.mean([r["ate_rmse"] for r in results.values()]))
    log("=" * 50, Channel.EVAL)
    for scene, r in results.items():
        log(f"{scene}: ATE RMSE {r['ate_rmse']:.4f}"
            + (f", chamfer {r['recon_chamfer']:.4f}" if "recon_chamfer" in r else ""),
            Channel.EVAL)
    log(f"average ATE RMSE: {avg:.4f}", Channel.EVAL)
    with open(os.path.join(cfg.output_dir, f"{args.dataset}_summary.json"), "w") as f:
        json.dump({"scenes": results, "avg_ate_rmse": avg}, f, indent=2)
    return results


if __name__ == "__main__":
    main()

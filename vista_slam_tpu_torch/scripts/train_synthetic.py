"""End-to-end learning proof: train a small STA frontend on the synthetic
textured-room scene, then run the full SLAM stack with the trained weights
on a held-out trajectory and compare ATE against random weights (the port
of scripts/train_synthetic.py).

One process, one device: ``make_train_step`` + ``TrainLoader`` over the
synthetic scene, the JAX script's schedule (warm-up 100, weight decay 0.01)
and Adam moment choices. The trained weights are written as the JAX
package's ``.npz`` (its ``load_params_npz`` reads them).

Usage:
  python -m vista_slam_tpu_torch.scripts.train_synthetic [--steps 1200]
      [--out $TMPDIR/synth_sta.npz] [--opt-state int8_fused] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from ..datasets.synthetic_scene import SyntheticSceneDataset, orbit_trajectory
from ..eval.traj import ape_statistics
from ..models.convert import save_params_npz
from ..models.sta import STA, STAConfig
from ..slam.frontend import FrontendEngine
from ..slam.online_slam import OnlineSLAM
from ..train.data import TrainLoader
from ..train.step import make_optimizer, make_train_step
from . import device_name, script_device

# the JAX script's model (its patch size comes from --patch); fp32 master
# weights under bf16 compute, as the port trains
CONFIG = STAConfig(img_size=(64, 64), patch_size=8, enc_dim=96, enc_depth=4,
                   enc_heads=4, dec_dim=64, dec_depth=4, dec_heads=4, mlp_ratio=4,
                   compute_dtype=torch.bfloat16, param_dtype=torch.float32)
DATASET = dict(n_frames=64, hw=(64, 64), focal=48.0, neighbor_num=1, loop_num=1,
               radius=2.0)
N_SUPPORT = 3  # 2 neighbours + 1 loop view per graph


def build_model(model_cfg: STAConfig, params: dict, device) -> STA:
    """An STA of ``model_cfg`` on ``device`` holding the state dict ``params``."""
    model = STA(model_cfg).to(device)
    model.load_state_dict(params)
    return model.eval()


def run_slam_eval(model_cfg, params, eval_poses, dataset_cls_kwargs, device="cuda"):
    """SLAM ATE (rmse, Sim(3)-aligned) of the frontend with the state dict
    ``params`` over the synthetic scene rendered along ``eval_poses``; NaN
    if any estimated pose is not finite."""
    ds = SyntheticSceneDataset(**dataset_cls_kwargs)
    ds.poses = eval_poses
    ds.n_frames = len(eval_poses)
    ds._cache.clear()
    engine = FrontendEngine(model_cfg, build_model(model_cfg, params, device))
    slam = OnlineSLAM(engine, loop_detector=None, max_view_num=64,
                      neighbor_edge_num=2, loop_edge_num=0, pgo_every=500,
                      rel_pose_thres=-1.0)
    n = len(eval_poses)
    for t in range(n):
        v = ds.view(t)
        slam.step({"rgb": v["img"], "gray": v["gray"],
                   "view_name": v["view_name"]}, force_pgo=(t == n - 1))
    est = np.stack([slam.get_view(k)["pose"] for k in range(slam.view_num)])
    if not np.isfinite(est).all():
        # ape_statistics drops non-finite poses: an all-NaN run would score 0
        return float("nan")
    return ape_statistics(est, eval_poses[:len(est)])["rmse"]


@torch.inference_mode()
def eval_pair_pose_error(model_cfg, params, ds, n_pairs=32, seed=7, device="cuda"):
    """Median relative-pose rotation error (deg) of the frontend on
    held-out view pairs — a more direct probe than full-SLAM ATE."""
    model = build_model(model_cfg, params, device)
    rng = np.random.default_rng(seed)
    errs = []
    for _ in range(n_pairs):
        i = int(rng.integers(0, ds.n_frames))
        j = (i + int(rng.integers(1, 4))) % ds.n_frames
        vi, vj = ds.view(i), ds.view(j)
        out = model(torch.as_tensor(vi["img"], device=device)[None],
                    torch.as_tensor(vj["img"], device=device)[None])
        pred = out["pose"][0].double().cpu().numpy()  # i in j's frame
        gt = np.linalg.inv(vj["camera_pose"]) @ vi["camera_pose"]
        cosang = np.clip((np.trace(pred[:3, :3].T @ gt[:3, :3]) - 1) / 2, -1, 1)
        errs.append(np.degrees(np.arccos(cosang)))
    return float(np.median(errs))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "synth_sta.npz"))
    ap.add_argument("--patch", type=int, default=8)
    ap.add_argument("--skip-eval", action="store_true")
    ap.add_argument("--opt-state", default="fp32",
                    choices=("fp32", "bf16", "int8", "bf16_fused", "int8_fused"),
                    help="Adam moment storage (train/quantized_opt.py): fp32, the "
                         "bf16/int8 carriers, or kernels K5 (bf16_fused) / K4 "
                         "(int8_fused)")
    ap.add_argument("--save-losses", default=None,
                    help="save the per-step loss sequence to this .npy "
                         "(same data order across --opt-state arms)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = script_device(args.device)
    print(f"device: {device_name(device)}")
    cfg = dataclasses.replace(CONFIG, patch_size=args.patch)
    ds = SyntheticSceneDataset(**DATASET)
    loader = TrainLoader(ds, args.batch, N_SUPPORT)

    model = STA(cfg).to(device)
    model.init_weights_(torch.Generator(device=device).manual_seed(0))
    params0 = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt = make_optimizer(lr=args.lr, warmup_steps=100, total_steps=args.steps,
                         weight_decay=0.01, state_dtype=args.opt_state)
    step_fn = make_train_step(model, opt, N_SUPPORT, device=device)

    step = 0
    epoch = 0
    t0 = time.time()
    losses = []
    while step < args.steps:
        loader.set_epoch(epoch)
        for batch in loader:
            loss, _ = step_fn(batch)
            step += 1
            losses.append(loss)
            if step % 100 == 0 or step == 1:
                print(f"step {step}: loss {loss.item():.3f} "
                      f"({(time.time() - t0):.0f}s)", flush=True)
            if step >= args.steps:
                break
        epoch += 1
    losses = torch.stack(losses).float().cpu().numpy()
    train_s = time.time() - t0
    trained = {k: v.detach().clone() for k, v in model.state_dict().items()}

    if args.save_losses:
        np.save(args.save_losses, losses)
        print(f"saved {len(losses)} per-step losses to {args.save_losses}")

    save_params_npz(args.out, trained)
    print(f"saved trained params to {args.out}")
    result = {"losses": losses, "train_s": train_s, "device": device_name(device)}

    if args.skip_eval:
        return result
    eval_ds = SyntheticSceneDataset(**{**DATASET, "radius": 1.6})
    rot_t = eval_pair_pose_error(cfg, trained, eval_ds, device=device)
    rot_r = eval_pair_pose_error(cfg, params0, eval_ds, device=device)
    print(f"frontend median rotation error: trained={rot_t:.2f} deg  "
          f"random={rot_r:.2f} deg")
    eval_poses = orbit_trajectory(20, radius=1.6, height=0.4).astype(np.float32)
    ate_trained = run_slam_eval(cfg, trained, eval_poses, DATASET, device)
    ate_random = run_slam_eval(cfg, params0, eval_poses, DATASET, device)
    print(f"SLAM ATE on held-out orbit: trained={ate_trained:.4f}  "
          f"random={ate_random:.4f}  "
          f"(improvement {ate_random / max(ate_trained, 1e-9):.1f}x)")
    return dict(result, rot_trained=rot_t, rot_random=rot_r,
                ate_trained=float(ate_trained), ate_random=float(ate_random))


if __name__ == "__main__":
    main()

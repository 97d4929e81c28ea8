"""Full-system loop-closure demo: learned frontend + in-repo-trained BoW
vocabulary + windowed Sim(3) PGO on a revisiting synthetic trajectory (the
port of scripts/demo_loop_closure.py).

Two revolutions of a 24-pose orbit, the second revisiting the first; the
vocabulary is trained on the first revolution's ORB features of 256x256
renders, while the frontend consumes 64x64 renders. Prints the loop edges
inserted and the ATE with and without loop closure. Needs OpenCV (ORB).

Usage:
  python -m vista_slam_tpu_torch.scripts.demo_loop_closure [weights.npz] [--device cpu]
(train the weights first with ``vista_slam_tpu_torch.scripts.train_synthetic``)
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from ..datasets.synthetic_scene import BoxScene, orbit_trajectory
from ..eval.traj import ape_statistics
from ..models.convert import load_params_npz, state_dict_from_jax
from ..models.sta import STA
from ..native.bow import train_vocabulary
from ..slam.frontend import FrontendEngine
from ..slam.loop_detector import LoopDetector
from ..slam.online_slam import OnlineSLAM
from ..utils.optional import require
from . import device_name, script_device
from .train_synthetic import CONFIG as _TRAIN_CONFIG

CONFIG = _TRAIN_CONFIG  # the learning proof's model, whose weights it loads
HW = (64, 64)
K64 = np.array([[48., 0, 32], [0, 48., 32], [0, 0, 1]], np.float32)
K256 = np.array([[192., 0, 128], [0, 192., 128], [0, 0, 1]])
REV = 24           # poses per revolution
LOOP_DIST_MIN = 10


def main(argv=None) -> dict:
    cv2 = require("cv2", "OpenCV")
    ap = argparse.ArgumentParser()
    ap.add_argument("weights", nargs="?",
                    default=os.path.join(tempfile.gettempdir(), "synth_sta.npz"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = script_device(args.device)
    print(f"device: {device_name(device)}")
    model = STA(CONFIG).to(device)
    model.load_state_dict(state_dict_from_jax(load_params_npz(args.weights)))
    scene = BoxScene()

    # two revolutions: second revisits the first
    one_rev = orbit_trajectory(REV, radius=1.6, height=0.4)
    poses = np.concatenate([one_rev, one_rev]).astype(np.float32)
    n = len(poses)

    frames = []
    orb = cv2.ORB_create()
    descs, ids = [], []
    for t in range(n):
        rgb, _ = scene.render(poses[t], K64, HW)
        rgb_hi, _ = scene.render(poses[t], K256, (256, 256))
        gray = (rgb_hi.mean(-1) * 255).astype(np.uint8)
        frames.append(((rgb * 2 - 1).astype(np.float32), gray))
        if t < REV:
            _, d = orb.detectAndCompute(gray, None)
            if d is not None:
                descs.append(d)
                ids.append(np.full(len(d), t))
    vocab = train_vocabulary(np.concatenate(descs), k=8, levels=3, seed=0,
                             image_ids=np.concatenate(ids))
    print(f"vocab: {vocab.num_words} words")

    def run(with_loop):
        det = LoopDetector(vocab, loop_dist_min=LOOP_DIST_MIN, loop_nms=3,
                           loop_cand_thresh_neighbor=4) if with_loop else None
        slam = OnlineSLAM(FrontendEngine(CONFIG, model), loop_detector=det,
                          max_view_num=64, neighbor_edge_num=2, loop_edge_num=2,
                          pgo_every=500, rel_pose_thres=-1.0)
        for t in range(n):
            slam.step({"rgb": frames[t][0], "gray": frames[t][1],
                       "view_name": f"f{t}"}, force_pgo=(t == n - 1))
        est = np.stack([slam.get_view(k)["pose"] for k in range(slam.view_num)])
        graph = slam.get_view_graph()
        loops = [(v, u) for v, us in graph.items() for u in us
                 if abs(v - u) > LOOP_DIST_MIN]
        ate = ape_statistics(est, poses[:len(est)])["rmse"]
        return ate, loops, est

    ate_loop, loops, traj = run(True)
    ate_noloop, _, _ = run(False)
    print(f"loop edges inserted: {len(loops)}")
    print(f"ATE with loop closure: {ate_loop:.4f}  without: {ate_noloop:.4f}")
    return {"ate_loop": float(ate_loop), "ate_noloop": float(ate_noloop),
            "loops": loops, "trajectory": traj, "words": vocab.num_words}


if __name__ == "__main__":
    main()

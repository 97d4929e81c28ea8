"""Long-sequence loop-closure stress at the flagship config (the port of
scripts/stress_long_run.py; the analog of the reference's ScanNet
scene0000 long run).

Drives the real pipeline at full production sizes on the device: 400
keyframes (224x224 bf16, neighbor_edge_num 3), BoW loop closure with an
in-repo-trained vocabulary, windowed PGO every ``--pgo-every`` keyframes,
the full artifact dump at the end. The sequence makes two passes over the
same visual strip, so the second half must retrieve loop edges against the
first. Reports stage timing, graph sizes, loop-edge count and buffer
headroom; ``--save-resume-at K`` also checks that a run resumed from the
state saved after keyframe K is bit-identical to the uninterrupted one.
Needs OpenCV (the strip, grey frames, ORB).

Usage:
  python -m vista_slam_tpu_torch.scripts.stress_long_run [--keyframes 400]
      [--pgo-every 100] [--save-resume-at 200] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from ..datasets.preprocess import to_model_inputs
from ..models.sta import STA, STAConfig
from ..native.bow import train_vocabulary
from ..slam.frontend import FrontendEngine
from ..slam.loop_detector import LoopDetector
from ..slam.online_slam import OnlineSLAM
from ..utils.optional import require
from . import device_name, script_device

CONFIG = STAConfig(compute_dtype=torch.bfloat16)  # the flagship 224x224 model
LOOP = dict(loop_dist_min=40, loop_nms=40, loop_cand_thresh_neighbor=5)


def make_frames(n, hw=(224, 224), revisit_at=0.5, seed=0):
    """Sliding crops over one long textured strip; the second
    ``1-revisit_at`` fraction replays the first pass's crops (loops)."""
    cv2 = require("cv2", "OpenCV")
    rng = np.random.default_rng(seed)
    h, w = hw
    first = int(n * revisit_at)
    strip_w = w + 4 * first
    strip = cv2.resize(rng.integers(0, 255, (h // 4, strip_w // 4, 3), np.uint8),
                       (strip_w, h), interpolation=cv2.INTER_CUBIC)
    frames = []
    for i in range(n):
        k = i if i < first else i - first  # second pass revisits
        x = 4 * k
        frames.append(strip[:, x:x + w].copy())
    return frames


def trajectory(slam) -> np.ndarray:
    return np.stack([slam.get_view(v, filter_outlier=False)["pose"]
                     for v in range(slam.view_num)])


def main(argv=None) -> dict:
    cv2 = require("cv2", "OpenCV")
    ap = argparse.ArgumentParser()
    ap.add_argument("--keyframes", type=int, default=400)
    ap.add_argument("--pgo-every", type=int, default=100)
    ap.add_argument("--combine", action="store_true",
                    help="combine neighbor+loop pairs into one dispatch/fetch")
    ap.add_argument("--save-resume-at", type=int, default=0, metavar="K",
                    help="after keyframe K, save_state; at the end, restore "
                         "into a FRESH OnlineSLAM on the same engine, replay "
                         "keyframes K..n, and require the resumed run's "
                         "trajectory to be bit-identical to the "
                         "uninterrupted one (the crash-recovery contract at "
                         "scale)")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "stress_out"))
    ap.add_argument("--print-every", type=int, default=100,
                    help="progress/cadence print interval (keyframes)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = script_device(args.device)
    print(f"device: {device_name(device)}")
    n = args.keyframes
    frames = make_frames(n)
    grays = [cv2.cvtColor(f, cv2.COLOR_RGB2GRAY) for f in frames]

    t0 = time.time()
    orb = cv2.ORB_create()
    descs, ids = [], []
    for i in range(0, n // 2, 4):  # vocab corpus: first pass only
        _, d = orb.detectAndCompute(grays[i], None)
        if d is not None:
            descs.append(d)
            ids.append(np.full(len(d), i))
    vocab = train_vocabulary(np.concatenate(descs), k=8, levels=3, seed=0,
                             image_ids=np.concatenate(ids))
    print(f"vocab: {vocab.num_words} words ({time.time() - t0:.1f}s)")

    model = STA(CONFIG).to(device)
    model.init_weights_(torch.Generator(device=device).manual_seed(0))
    engine = FrontendEngine(CONFIG, model)

    def new_slam():
        return OnlineSLAM(engine, loop_detector=LoopDetector(vocab, **LOOP),
                          max_view_num=n, neighbor_edge_num=3, loop_edge_num=2,
                          pgo_every=args.pgo_every, rel_pose_thres=-1.0,
                          combine_loop_batch=args.combine)

    def step(slam, i):
        inputs = to_model_inputs(frames[i])
        slam.step({"rgb": inputs["rgb"], "gray": inputs["gray"],
                   "view_name": f"kf_{i:05d}"}, force_pgo=(i == n - 1))

    slam = new_slam()
    ckpt_path = os.path.join(tempfile.gettempdir(), "stress_state.npz")
    t0 = time.time()
    for i in range(n):
        step(slam, i)
        if args.save_resume_at and i + 1 == args.save_resume_at:
            ts = time.time()
            slam.save_state(ckpt_path, frame_cursor=i + 1)
            print(f"  kf {i + 1}: save_state -> {ckpt_path} "
                  f"({os.path.getsize(ckpt_path) / 1e6:.0f} MB, "
                  f"{time.time() - ts:.1f}s)", flush=True)
        if (i + 1) % args.print_every == 0:
            g = slam.graph
            print(f"  kf {i + 1}: nodes {g.num_nodes}/{g.max_nodes} "
                  f"edges {g.num_edges}/{g.max_edges} "
                  f"({(time.time() - t0) / (i + 1):.2f} s/kf avg)", flush=True)
    wall = time.time() - t0

    g = slam.graph
    loop_edges = sum(1 for v, js in slam.get_view_graph().items()
                     for j in js if abs(v - j) > LOOP["loop_dist_min"])
    td = slam.get_time_dict()
    print(f"\n{n} keyframes in {wall:.1f}s ({n / wall:.2f} kf/s end-to-end)")
    print(f"stage timing: { {k: round(v, 1) for k, v in td.items()} }")
    print(f"host syncs: {engine.fetch_count} blocking fetches "
          f"({engine.fetch_count / n:.2f}/kf, one packed array each)")
    print(f"graph: {g.num_nodes}/{g.max_nodes} nodes, "
          f"{g.num_edges}/{g.max_edges} edges, {loop_edges} loop edges")
    traj = trajectory(slam)
    if not np.isfinite(traj).all():
        raise AssertionError("non-finite pose after long run")
    print("trajectory finite; saving artifacts ...")
    slam.save_data_all(args.out)
    print(f"artifacts in {args.out}")
    result = {"trajectory": traj, "loop_edges": loop_edges, "wall_s": wall,
              "resume_identical": None}

    if args.save_resume_at:
        k = args.save_resume_at
        print(f"\nresume check: fresh OnlineSLAM <- {ckpt_path}, "
              f"replaying keyframes {k}..{n} ...", flush=True)
        slam2 = new_slam()
        extra = slam2.load_state(ckpt_path)
        t0 = time.time()
        for i in range(int(extra["frame_cursor"]), n):
            step(slam2, i)
        print(f"resumed arm: {n - k} keyframes in {time.time() - t0:.1f}s")
        traj2 = trajectory(slam2)
        if slam2.view_num != slam.view_num:
            raise AssertionError(f"resumed run has {slam2.view_num} views, "
                                 f"not {slam.view_num}")
        if slam2.get_view_graph() != slam.get_view_graph():
            raise AssertionError("resumed run changed the view graph")
        if not np.array_equal(traj2, traj):
            d = np.abs(traj2 - traj).max()
            raise AssertionError(f"resumed trajectory differs (max {d:.3g})")
        print("resume BIT-IDENTICAL to the uninterrupted run "
              f"({slam2.graph.num_edges} edges, {slam2.view_num} views)")
        result["resume_identical"] = True
    return result


if __name__ == "__main__":
    main()

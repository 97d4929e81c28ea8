"""Offline SLAM entry point of the port: run on an image glob.

Usage:
  python -m vista_slam_tpu_torch.cli.run --config configs/highres.yaml \
      --images '/path/to/images/*.png' [--output DIR] [--verbose]

The same loop as vista_slam_tpu/cli/run.py (reference: run.py:93-265):
stride / flow / flow_stride keyframing with the automatic restart in stride
mode, batch-encoded keyframes ahead of the loop in stride mode, a final
forced PGO, stage timing, the artifact dump, a state checkpoint every
``state_every`` keyframes and ``--resume-state``. ``run_sequence`` takes any
indexable dataset of {'rgb', 'gray', 'img_name'} dicts, so it runs from
in-memory frames; yaml, PIL and the image dataset are imported in ``main``.
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np

from ..utils.logging import Channel, log
from .common import build_slam, select_stride_indices

PREFETCH_CHUNK = 8  # keyframes batch-encoded ahead in stride mode


def run_sequence(slam, dataset, cfg, progress: bool = True,
                 start_frame: int = 0) -> float:
    """Drive the keyframe loop over a dataset; returns the data-read time.

    Every ``cfg.state_every`` keyframes (0: never) the SLAM state goes to
    ``<output_dir>/slam_state.npz`` with the frame cursor; start_frame > 0
    resumes after OnlineSLAM.load_state (the saved cursor + 1)."""
    n = len(dataset)
    stride_mode = cfg.keyframe_detection == "stride"
    stride_idxes = (select_stride_indices(n, cfg.stride, cfg.max_view_num)
                    if stride_mode else None)
    state_every = int(cfg.get("state_every", 0) or 0)
    state_path = os.path.join(cfg.output_dir, "slam_state.npz")
    read_time = 0.0
    t = start_frame
    first = start_frame == 0
    is_optimized = False
    pending: dict[int, tuple] = {}
    while t < n:
        t_read = time.time()
        feat = None
        if stride_mode:
            is_kf = t in stride_idxes
            if not is_kf:
                data = None
            elif t in pending:
                data, feat = pending.pop(t)
            else:
                # chunks sit at fixed positions of the keyframe order, so a
                # resumed run encodes the same batches as an uninterrupted one
                ordered = sorted(stride_idxes)
                pos = ordered.index(t)
                lo = pos - pos % PREFETCH_CHUNK
                chunk = ordered[lo: lo + PREFETCH_CHUNK]
                datas = [dataset[s] for s in chunk]
                feats = slam.frontend.encode_batch(np.stack([d["rgb"] for d in datas]))
                pending = dict(zip(chunk, zip(datas, feats)))
                data, feat = pending.pop(t)
        else:
            data = dataset[t]
            is_kf = slam.flow_tracker.is_new_keyframe(data["gray"])
        read_time += time.time() - t_read

        if not is_kf:
            if t == n - 1 and not is_optimized:
                slam.pose_graph_optimize()
            t += 1
            continue

        value = {"rgb": data["rgb"], "gray": data.get("gray"),
                 "view_name": data.get("img_name", f"frame_{t}"),
                 "enc_feat": feat}
        is_optimized = slam.step(value, force_pgo=(t == n - 1))
        if state_every and slam.view_num % state_every == 0:
            slam.save_state(state_path, frame_cursor=t)
        if cfg.get("rerun_vis") or cfg.get("rerun_save"):
            from ..utils import rerun_vis

            rerun_vis.set_time(t)
            rerun_vis.log_slam_views(slam, show_all=is_optimized)

        if first:
            first = False
            t += 1
            continue

        if slam.view_num > cfg.max_view_num:
            if cfg.keyframe_detection == "flow_stride":
                log(f"max_view_num {cfg.max_view_num} reached; restarting in "
                    f"stride mode (stride={cfg.stride})", Channel.WARNING)
                stride_mode = True
                stride_idxes = select_stride_indices(n, cfg.stride, cfg.max_view_num)
                pending.clear()
                slam.reset()
                t = 0
                first = True
                read_time = 0.0
                is_optimized = False
                continue
            log(f"max_view_num {cfg.max_view_num} reached; stopping early",
                Channel.WARNING)
            slam.pose_graph_optimize()
            is_optimized = True
            break

        if progress and t % 50 == 0:
            log(f"[{t + 1}/{n}] keyframes={slam.view_num}")
        t += 1
    return read_time


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", required=True)
    parser.add_argument("--images", required=True,
                        help="glob of input images, e.g. '/data/seq/*.png'")
    parser.add_argument("--output", default=None)
    parser.add_argument("--vis", action="store_true",
                        help="stream live visualization via rerun")
    parser.add_argument("--vis-save", action="store_true",
                        help="save a rerun recording next to the outputs")
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--resume-state", default=None,
                        help="resume from an OnlineSLAM.save_state checkpoint "
                             "(written every cfg.state_every keyframes as "
                             "<output>/slam_state.npz)")
    args = parser.parse_args(argv)

    import torch

    from ..datasets.slam_sequences import SLAMImagesOnly
    from ..utils import rerun_vis
    from ..utils.config import load_config

    # full fp32 in fp32 matmuls and convolutions (the heads' numerics)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = load_config(args.config, output_dir=args.output,
                      verbose=args.verbose or None,
                      rerun_vis=args.vis or None, rerun_save=args.vis_save or None)
    np.random.seed(int(cfg.random_seed))
    os.makedirs(cfg.output_dir, exist_ok=True)

    res = tuple((cfg.get("model", {}) or {}).get("img_size", (224, 224)))
    dataset = SLAMImagesOnly(glob.glob(args.images), resolution=res)
    if len(dataset) == 0:
        raise SystemExit(f"no images matched {args.images}")
    log(f"{len(dataset)} frames")

    slam = build_slam(cfg)
    start_frame = 0
    if args.resume_state:
        extras = slam.load_state(args.resume_state)
        start_frame = int(extras.get("frame_cursor", -1)) + 1
        log(f"resumed {slam.view_num} keyframes from {args.resume_state}; "
            f"continuing at frame {start_frame}")
    if cfg.get("rerun_vis") or cfg.get("rerun_save"):
        rerun_vis.init("slam",
                       save_path=(os.path.join(cfg.output_dir, "recording.rrd")
                                  if cfg.get("rerun_save") else None),
                       url=cfg.get("rerun_url"))
    read_time = run_sequence(slam, dataset, cfg, start_frame=start_frame)

    log(f"total keyframes detected: {slam.view_num}")
    td = slam.get_time_dict()
    td["prepare_data"] += read_time
    td["total"] += read_time
    log(f"total time: {td['total']:.1f}s")
    if cfg.verbose:
        log(f"stage timing: { {k: round(v, 2) for k, v in td.items()} }")

    rerun_vis.disconnect()
    log(f"saving artifacts to {cfg.output_dir} ...")
    slam.save_data_all(cfg.output_dir)
    log("done.")
    return slam


if __name__ == "__main__":
    main()

"""Live-camera SLAM with the port: threaded latest-frame capture and flow
keyframing, the loop of vista_slam_tpu/cli/run_live.py (reference:
run_live.py). A background thread keeps only the newest frame; keyframes
are chosen by optical flow only; the live config's pgo_every runs frequent
incremental PGO. The source is a camera index, a video file or an
MJPEG/RTSP URL (the reference's remote_live_setting streams MJPEG over an
SSH tunnel; ``cli/stream_camera.py`` serves one).

Usage:
  python -m vista_slam_tpu_torch.cli.run_live --config configs/live.yaml \
      [--camera 0 | --camera http://host:5000/video] [--max-frames N]

Capture and flow keyframing need OpenCV; it is imported where they start,
and its absence raises a ModuleNotFoundError that names it.
"""

from __future__ import annotations

import argparse
import os
import threading
import time

from ..utils.logging import Channel, log
from ..utils.optional import require
from .common import build_slam


class LatestCamera:
    """Background reader that exposes only the newest frame (reference:
    run_live.py:84-113)."""

    def __init__(self, source):
        cv2 = require("cv2", "OpenCV", "live capture")
        self.cap = cv2.VideoCapture(int(source) if str(source).isdigit() else source)
        if not self.cap.isOpened():
            raise RuntimeError(f"cannot open camera source {source}")
        self._lock = threading.Lock()
        self._frame = None
        self._running = True
        self._thread = threading.Thread(target=self._reader, daemon=True)
        self._thread.start()

    def _reader(self):
        while self._running:
            ok, frame = self.cap.read()
            if not ok:
                time.sleep(0.005)
                continue
            with self._lock:
                self._frame = frame

    def read_latest(self):
        """The newest frame (BGR uint8) not read before, or None."""
        with self._lock:
            frame, self._frame = self._frame, None
        return frame

    def close(self):
        self._running = False
        self._thread.join(timeout=1.0)
        self.cap.release()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True)
    ap.add_argument("--camera", default="0")
    ap.add_argument("--output", default=None)
    ap.add_argument("--max-frames", type=int, default=0,
                    help="stop after N keyframes (0 = until interrupted)")
    ap.add_argument("--idle-timeout", type=float, default=0.0,
                    help="stop if the source delivers no frame for this many "
                         "seconds (0 = wait forever); guards against dropped "
                         "streams and lets finite sources (video files) end")
    args = ap.parse_args(argv)

    cv2 = require("cv2", "OpenCV", "live capture")
    from ..datasets.preprocess import crop_resize, to_model_inputs
    from ..utils.config import load_config

    cfg = load_config(args.config, output_dir=args.output)
    cfg.keyframe_detection = "flow"  # forced in live mode (reference run_live.py:139)
    os.makedirs(cfg.output_dir, exist_ok=True)

    slam = build_slam(cfg, live_mode=True)
    cam = LatestCamera(args.camera)
    res = tuple((cfg.get("model", {}) or {}).get("img_size", (224, 224)))
    state_every = int(cfg.get("state_every", 0) or 0)
    log("live mode started: ctrl-c to stop and save", Channel.INFO)
    last_frame_t = time.time()
    try:
        while True:
            frame = cam.read_latest()
            if frame is None:
                if args.idle_timeout and time.time() - last_frame_t > args.idle_timeout:
                    log("no frames from the source: stopping", Channel.WARNING)
                    break
                time.sleep(0.002)
                continue
            last_frame_t = time.time()
            rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            rgb, _, _ = crop_resize(rgb, None, None, res, w_edge=10, h_edge=10)
            inputs = to_model_inputs(rgb)
            if not slam.flow_tracker.is_new_keyframe(inputs["gray"]):
                continue
            slam.step({"rgb": inputs["rgb"], "gray": inputs["gray"],
                       "view_name": f"live_{slam.view_num:05d}"})
            if state_every and slam.view_num % state_every == 0:
                slam.save_state(os.path.join(cfg.output_dir, "slam_state.npz"))
            if args.max_frames and slam.view_num >= args.max_frames:
                break
            if slam.view_num >= cfg.max_view_num:
                log("keyframe budget reached: stopping", Channel.WARNING)
                break
    except KeyboardInterrupt:
        log("interrupted", Channel.WARNING)
    finally:
        cam.close()

    if slam.view_num > 1:
        slam.pose_graph_optimize()
        slam.save_data_all(cfg.output_dir)
        log(f"saved {slam.view_num} keyframes to {cfg.output_dir}", Channel.INFO)
    return slam


if __name__ == "__main__":
    main()

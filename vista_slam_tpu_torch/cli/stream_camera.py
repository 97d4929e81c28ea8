"""MJPEG camera streaming server for remote live SLAM, on the standard
library (the counterpart of vista_slam_tpu/cli/stream_camera.py, replacing
the reference's Flask streamers, remote_live_setting/live.py and
live_realsense.py). Run it on the machine with the camera, tunnel the port
(e.g. ``ssh -R 5000:localhost:5000 gpu-host``), then point run_live at it:

  # camera machine
  python -m vista_slam_tpu_torch.cli.stream_camera --camera 0 --port 5000
  # SLAM machine
  python -m vista_slam_tpu_torch.cli.run_live --config configs/live.yaml \
      --camera http://localhost:5000/video

Capture and JPEG encoding need OpenCV (imported in ``main``; its absence
raises a ModuleNotFoundError that names it).
"""

from __future__ import annotations

import argparse
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..utils.optional import require


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--camera", default="0")
    ap.add_argument("--realsense", action="store_true",
                    help="capture the color stream of an Intel RealSense "
                         "instead of a cv2 camera (needs pyrealsense2; "
                         "reference: remote_live_setting/live_realsense.py)")
    ap.add_argument("--port", type=int, default=5000)
    ap.add_argument("--fps", type=float, default=20.0)
    ap.add_argument("--quality", type=int, default=85)
    args = ap.parse_args(argv)

    cv2 = require("cv2", "OpenCV", "camera streaming")
    if args.realsense:
        try:
            import numpy as np
            import pyrealsense2 as rs
        except ImportError as e:
            raise SystemExit("--realsense requires pyrealsense2") from e
        pipe = rs.pipeline()
        rcfg = rs.config()
        rcfg.enable_stream(rs.stream.color, 640, 480, rs.format.bgr8, 30)
        pipe.start(rcfg)

        def read():
            color = pipe.wait_for_frames().get_color_frame()
            return np.asanyarray(color.get_data()) if color else None
    else:
        cap = cv2.VideoCapture(int(args.camera) if str(args.camera).isdigit()
                               else args.camera)
        if not cap.isOpened():
            raise SystemExit(f"cannot open camera {args.camera}")

        def read():
            ok, frame = cap.read()
            return frame if ok else None

    latest = {"jpg": None}
    lock = threading.Lock()

    def grab():
        while True:
            frame = read()
            if frame is None:
                time.sleep(0.01)
                continue
            ok, buf = cv2.imencode(".jpg", frame, [cv2.IMWRITE_JPEG_QUALITY, args.quality])
            if ok:
                with lock:
                    latest["jpg"] = buf.tobytes()

    threading.Thread(target=grab, daemon=True).start()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            if self.path != "/video":
                self.send_response(404)
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Type", "multipart/x-mixed-replace; boundary=frame")
            self.end_headers()
            period = 1.0 / args.fps
            try:
                while True:
                    with lock:
                        jpg = latest["jpg"]
                    if jpg is not None:
                        self.wfile.write(b"--frame\r\n")
                        self.send_header("Content-Type", "image/jpeg")
                        self.send_header("Content-Length", str(len(jpg)))
                        self.end_headers()
                        self.wfile.write(jpg)
                        self.wfile.write(b"\r\n")
                    time.sleep(period)
            except (BrokenPipeError, ConnectionResetError):
                pass

    print(f"streaming camera {args.camera} at http://0.0.0.0:{args.port}/video", flush=True)
    ThreadingHTTPServer(("0.0.0.0", args.port), Handler).serve_forever()


if __name__ == "__main__":
    main()

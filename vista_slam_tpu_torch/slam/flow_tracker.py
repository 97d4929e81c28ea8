"""Optical-flow keyframe selection (host-side, OpenCV).

Same capability as the reference tracker (vista_slam/flow_tracker.py:5-66):
Shi-Tomasi corners on the last keyframe, pyramidal Lucas-Kanade into the
current frame; a new keyframe is declared when the mean track displacement
exceeds a threshold or fewer than 10 points survive.
"""

from __future__ import annotations

import numpy as np

from ..utils.optional import missing

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


class FlowTracker:
    def __init__(self, min_disparity: float = 5.0, max_corners: int = 1000):
        if cv2 is None:
            raise missing("cv2", "OpenCV", "FlowTracker")
        self.min_disparity = float(min_disparity)
        self.max_corners = int(max_corners)
        self.reset()

    def reset(self):
        self.kf_gray: np.ndarray | None = None
        self.kf_pts: np.ndarray | None = None

    def _set_keyframe(self, gray: np.ndarray):
        self.kf_gray = gray
        self.kf_pts = cv2.goodFeaturesToTrack(
            gray, maxCorners=self.max_corners, qualityLevel=0.01,
            minDistance=8, blockSize=7)

    def is_new_keyframe(self, gray: np.ndarray) -> bool:
        """gray: uint8 [H, W]. Returns True (and re-seeds) on a new keyframe."""
        if self.kf_gray is None or self.kf_pts is None or len(self.kf_pts) < 10:
            self._set_keyframe(gray)
            return True

        nxt, status, _ = cv2.calcOpticalFlowPyrLK(
            self.kf_gray, gray, self.kf_pts, None,
            winSize=(21, 21), maxLevel=3,
            criteria=(cv2.TERM_CRITERIA_EPS | cv2.TERM_CRITERIA_COUNT, 30, 0.01))
        ok = status.ravel() == 1
        if ok.sum() < 10:
            self._set_keyframe(gray)
            return True
        disp = np.linalg.norm(nxt[ok] - self.kf_pts[ok], axis=-1).mean()
        if disp > self.min_disparity:
            self._set_keyframe(gray)
            return True
        return False

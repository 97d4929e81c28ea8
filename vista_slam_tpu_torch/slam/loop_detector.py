"""Bag-of-words loop-closure candidate detection (host-side).

Capability-matched to the reference detector (vista_slam/loop_detector.py):
ORB features -> BoW vector; the similarity threshold adapts to the minimum
similarity over the last ``loop_cand_thresh_neighbor`` temporal neighbors;
candidates must be at least ``loop_dist_min`` frames away and are spaced by
``loop_nms`` non-maximum suppression; results are sorted by similarity.
The ORB features come from OpenCV: without it the detector raises at
construction rather than find no loop.
"""

from __future__ import annotations

import numpy as np

from ..native.bow import BowVector, Vocabulary
from ..utils.optional import missing

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


class LoopDetector:
    def __init__(self, vocab: Vocabulary | str, loop_dist_min: int = 40,
                 loop_nms: int = 40, loop_cand_thresh_neighbor: int = 5):
        if cv2 is None:
            raise missing("cv2", "OpenCV", "LoopDetector's ORB features")
        if isinstance(vocab, str):
            v = Vocabulary()
            v.load(vocab)
            vocab = v
        self.vocab = vocab
        self.loop_dist_min = loop_dist_min
        self.loop_nms = loop_nms
        self.loop_cand_thresh_neighbor = loop_cand_thresh_neighbor
        self.bow_feats: list[BowVector | None] = []
        self.orb = cv2.ORB_create()

    def compute_bow(self, gray: np.ndarray) -> BowVector | None:
        """gray uint8 [H, W] -> BoW vector appended to the database."""
        _, descriptors = self.orb.detectAndCompute(gray, None)
        vec = self.vocab.transform(descriptors) if descriptors is not None else None
        self.bow_feats.append(vec)
        return vec

    def detect(self, gray: np.ndarray, farthest_neighbor: int) -> list[tuple[int, float]]:
        """Register the frame and return [(view_id, similarity), ...] loop
        candidates sorted by decreasing similarity."""
        vec = self.compute_bow(gray)
        i = len(self.bow_feats) - 1
        if vec is None:
            return []

        neighbor_lo = max(0, i - self.loop_cand_thresh_neighbor)
        neighbor_sims = [
            self.vocab.score(vec, self.bow_feats[j])
            for j in range(neighbor_lo, i)
            if self.bow_feats[j] is not None
        ]
        sim_thresh = min(neighbor_sims) if neighbor_sims else 1.0

        candidates: list[tuple[int, float]] = []
        last_edge = farthest_neighbor
        for j in reversed(range(farthest_neighbor)):
            if last_edge - j > self.loop_nms and i - j > self.loop_dist_min:
                if self.bow_feats[j] is None:
                    continue
                sim = self.vocab.score(vec, self.bow_feats[j])
                if sim > sim_thresh:
                    candidates.append((j, sim))
                    last_edge = j
        return sorted(candidates, key=lambda x: x[1], reverse=True)

    def reset(self):
        self.bow_feats.clear()

"""Epipolar consistency metric (``videogpa_tpu/metrics/epipolar.py``, SIFT path).

Consecutive-frame SIFT keypoint matching with Lowe's ratio test (0.75), the
normalised 8-point fundamental matrix and the mean sqrt-Sampson distance in
pixels; -1.0 when no frame pair yields enough matches. Matching is host
OpenCV, imported inside the functions that use it (the machine that holds the
card may have none); the geometry is ``metrics.functional`` on CPU tensors.
The learned SuperPoint + LightGlue matcher is not ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from videogpa_torch.metrics.functional import find_fundamental, sampson_distance


class SIFTMatcher:
    """OpenCV SIFT + brute-force kNN matching. ``cv2`` is imported, and the
    detector made, at the first match, so a metric set that holds Epipolar
    can be built where OpenCV is absent."""

    def __init__(self, ratio_thresh: float = 0.75, min_matches: int = 20):
        self.ratio_thresh = ratio_thresh
        self.min_matches = min_matches
        self.sift = None

    def get_matched_points(
        self, frame1: np.ndarray, frame2: np.ndarray
    ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray], int]:
        import cv2

        if self.sift is None:
            self.sift = cv2.SIFT_create()

        def gray(f):
            if f.ndim == 3:
                if f.shape[0] == 3:
                    f = f.transpose(1, 2, 0)
                return cv2.cvtColor(f, cv2.COLOR_RGB2GRAY)
            return f

        kp1, d1 = self.sift.detectAndCompute(gray(frame1), None)
        kp2, d2 = self.sift.detectAndCompute(gray(frame2), None)
        if len(kp1) < 8 or len(kp2) < 8 or d1 is None or d2 is None:
            return None, None, 0

        matches = cv2.BFMatcher().knnMatch(d1, d2, k=2)
        good = [m for pair in matches if len(pair) == 2
                for m, n in [pair] if m.distance < self.ratio_thresh * n.distance]
        if len(good) < self.min_matches:
            return None, None, len(good)

        pts1 = np.array([kp1[m.queryIdx].pt for m in good], np.float32)
        pts2 = np.array([kp2[m.trainIdx].pt for m in good], np.float32)
        return pts1, pts2, len(good)


def frames_to_uint8(x) -> np.ndarray:
    """Accept (T,C,H,W)/(T,H,W,C) in [-1,1]/[0,1]/[0,255] -> (T,H,W,C) uint8."""
    x = np.asarray(x)
    if x.ndim == 3:
        x = x[None]
    if x.shape[1] in (1, 3) and x.shape[-1] not in (1, 3):
        x = x.transpose(0, 2, 3, 1)
    if x.min() < 0:
        x = (x + 1.0) * 127.5
    elif x.max() <= 1.0:
        x = x * 255.0
    return np.clip(x, 0, 255).astype(np.uint8)


def epipolar_error(frames, matcher: Optional[SIFTMatcher] = None) -> float:
    """Mean Sampson distance (px) over consecutive frame pairs; -1.0 if none."""
    matcher = matcher or SIFTMatcher()
    frames = frames_to_uint8(frames)
    errors = []
    for i in range(len(frames) - 1):
        pts1, pts2, _ = matcher.get_matched_points(frames[i], frames[i + 1])
        if pts1 is None:
            continue
        p1, p2 = torch.from_numpy(pts1), torch.from_numpy(pts2)
        F = find_fundamental(p1, p2)
        if not bool(torch.isfinite(F).all()):
            continue
        errors.append(float(sampson_distance(p1, p2, F, squared=False).mean()))
    if not errors:
        return -1.0
    return float(np.mean(errors))

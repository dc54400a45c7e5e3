"""Epipolar consistency metric (``videogpa_tpu/metrics/epipolar.py``).

Consecutive-frame keypoint matching, the normalised 8-point fundamental
matrix and the mean sqrt-Sampson distance in pixels; -1.0 when no frame pair
yields enough matches. Two matchers, as in the JAX package: SIFT with Lowe's
ratio test (0.75), host OpenCV imported at the first match (the machine that
holds the card may have none), and the learned SuperPoint + LightGlue
(``models.matching``) on the matcher's device. The geometry is
``metrics.functional`` on CPU tensors.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from videogpa_torch.checkpoint import load_pytree
from videogpa_torch.convert import load_jax_params
from videogpa_torch.device import resolve_device
from videogpa_torch.metrics.functional import find_fundamental, sampson_distance
from videogpa_torch.models.matching import (
    LightGlue,
    LightGlueConfig,
    SuperPoint,
    SuperPointConfig,
    extract_keypoints,
    lightglue_config_of,
    lightglue_init,
    lightglue_match,
    superpoint_config_of,
    superpoint_forward,
    superpoint_init,
)


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


def grey_pair(frame1: np.ndarray, frame2: np.ndarray) -> np.ndarray:
    """Two (H, W, 3) uint8 frames -> the matcher's (2, 1, Hp, Wp) f32 input:
    grey in float64, / 255, zero-padded to sides divisible by 8, on the host
    (``videogpa_tpu/metrics/epipolar.py:110-120``)."""
    def grey(f):
        if f.ndim == 3:
            return 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]
        return f.astype(np.float32)

    H, W = frame1.shape[:2]
    imgs = np.zeros((2, 1, -(-H // 8) * 8, -(-W // 8) * 8), np.float32)
    imgs[0, 0, :H, :W] = grey(frame1) / 255.0
    imgs[1, 0, :H, :W] = grey(frame2) / 255.0
    return imgs


class LightGlueMatcher:
    """SuperPoint + LightGlue on ``device`` (``resolve_device``: the card
    unless the caller asks for the CPU), the reference scorer's learned
    descriptor (``videogpa_tpu/metrics/epipolar.py::LightGlueMatcher``).

    Weights: pass the modules, or name ``.npz`` files of the JAX package's
    trees (``save_pytree``) with ``VIDEOGPA_SUPERPOINT_PATH`` /
    ``VIDEOGPA_LIGHTGLUE_PATH``. Without either, each net is drawn from a
    ``torch.Generator`` seeded with 0 (the JAX package draws from
    ``PRNGKey(0)``: other numbers). ``sp_cfg`` and ``lg_cfg`` are public, as
    in the JAX package: keypoint count, NMS radius and detection threshold,
    heads and the match threshold are read from them at each match."""

    def __init__(self, min_matches: int = 20, sp_params: Optional[SuperPoint] = None,
                 lg_params: Optional[LightGlue] = None, device=None):
        self.min_matches = min_matches
        self.sp_cfg = SuperPointConfig()
        self.lg_cfg = LightGlueConfig()
        self.device = resolve_device(device)

        def load(env, provided, build, config_of, init, cfg):
            if provided is not None:
                return provided.to(self.device)
            path = os.environ.get(env)
            if path and os.path.exists(path):
                tree = load_pytree(path)
                return load_jax_params(build(config_of(tree, cfg)), tree).eval().to(self.device)
            return init(cfg, torch.Generator(device=self.device).manual_seed(0), self.device)

        self.sp_params = load("VIDEOGPA_SUPERPOINT_PATH", sp_params, SuperPoint,
                              superpoint_config_of, superpoint_init, self.sp_cfg)
        self.lg_params = load("VIDEOGPA_LIGHTGLUE_PATH", lg_params, LightGlue,
                              lightglue_config_of, lightglue_init, self.lg_cfg)

    @torch.no_grad()
    def get_matched_points(self, frame1: np.ndarray, frame2: np.ndarray):
        imgs = grey_pair(frame1, frame2)
        Hp, Wp = imgs.shape[-2:]
        scores, desc = superpoint_forward(self.sp_params, torch.from_numpy(imgs).to(self.device),
                                          self.sp_cfg)
        kpts, _, descs, valid = extract_keypoints(scores, desc, self.sp_cfg)
        matches0, _ = lightglue_match(self.lg_params, kpts[:1], descs[:1], valid[:1],
                                      kpts[1:], descs[1:], valid[1:], (Hp, Wp), self.lg_cfg)
        m = matches0[0].cpu().numpy()
        good = m >= 0
        n = int(good.sum())
        if n < self.min_matches:
            return None, None, n
        kp = kpts.cpu().numpy()
        return kp[0][good].astype(np.float32), kp[1][m[good]].astype(np.float32), n


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

"""Nested DA3 (``videogpa_tpu/models/da3/nested.py``): the anyview branch and
the metric mono branch, aligned by one scale.

The reference's ``NestedDepthAnything3Net`` (``model/da3.py:301-435``) and
``utils/alignment.py``, preset ``da3nested-giant-large``: two independent
forwards on the card (DA3-Giant, then the metric DA3-Large) and a closed-form
alignment on the host. The metric branch's focal-scaled depth anchors the
anyview branch's relative depth through a least-squares scalar, the
trajectory is rescaled with it, and the sky pixels of the metric branch's
sky head go to the 99th-percentile depth. The alignment is the JAX package's
numpy code, ``_sample_for_quantile``'s seeded subsampling included, so the
scale factor is the same on the same depths.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from videogpa_torch.models.da3.model import DA3, DA3Prediction, da3_inference
from videogpa_torch.models.da3.mono import DA3Mono, compute_sky_mask, mono_inference
from videogpa_torch.utils.timing import StageTimer


def least_squares_scale_scalar(a: np.ndarray, b: np.ndarray, eps: float = 1e-12) -> float:
    """Scale s with a ~= s * b (reference utils/alignment.py:23-51)."""
    num = float(np.dot(a.reshape(-1), b.reshape(-1)))
    den = max(float(np.dot(b.reshape(-1), b.reshape(-1))), eps)
    return num / den


def apply_metric_scaling(depth: np.ndarray, intrinsics: np.ndarray,
                         scale_factor: float = 300.0) -> np.ndarray:
    """Focal-normalised metric scaling (reference utils/alignment.py:118-133):
    depth (S, H, W), intrinsics (S, 3, 3) in pixels."""
    focal = (intrinsics[:, 0, 0] + intrinsics[:, 1, 1]) / 2
    return depth * (focal[:, None, None] / scale_factor)


def compute_alignment_mask(depth_conf: np.ndarray, non_sky_mask: np.ndarray, depth: np.ndarray,
                           metric_depth: np.ndarray, median_conf: float,
                           min_depth_threshold: float = 1e-3,
                           min_metric_depth_threshold: float = 1e-2) -> np.ndarray:
    return ((depth_conf >= median_conf)
            & non_sky_mask
            & (metric_depth > min_metric_depth_threshold)
            & (depth > min_depth_threshold)
            # degenerate cameras can give non-finite focal-scaled depth; it
            # must not poison the least-squares scale
            & np.isfinite(metric_depth)
            & np.isfinite(depth))


def _sample_for_quantile(x: np.ndarray, max_samples: int = 100_000) -> np.ndarray:
    if x.size <= max_samples:
        return x
    rng = np.random.default_rng(0)
    return x.reshape(-1)[rng.permutation(x.size)[:max_samples]]


@dataclasses.dataclass
class NestedPrediction(DA3Prediction):
    is_metric: int = 0
    scale_factor: float = 1.0


def align_to_metric(pred: DA3Prediction, metric_depth: np.ndarray, sky: Optional[np.ndarray],
                    sky_depth_def: float = 200.0) -> NestedPrediction:
    """The nested net's alignment after both forwards (da3.py:367-435):
    metric_depth (S, H, W) focal-scaled, sky (S, H, W) the metric branch's
    sky map or None."""
    depth = pred.depth.copy()
    conf = None if pred.conf is None else pred.conf.copy()
    extr = pred.extrinsics.copy()

    non_sky = compute_sky_mask(sky, 0.3) if sky is not None else np.ones_like(depth, bool)
    if non_sky.sum() <= 10:
        raise ValueError("Insufficient non-sky pixels for alignment")

    median_conf = float(np.quantile(_sample_for_quantile(conf[non_sky]), 0.5)
                        ) if conf is not None else -np.inf
    align = compute_alignment_mask(conf if conf is not None else np.ones_like(depth),
                                   non_sky, depth, metric_depth, median_conf)
    scale = (least_squares_scale_scalar(metric_depth[align], depth[align])
             if align.any() else 1.0)
    if not np.isfinite(scale) or scale <= 0:
        scale = 1.0  # keep the relative scale rather than destroy the output
    depth *= scale
    extr[:, :3, 3] *= scale

    # sky pixels -> min(q99 of the non-sky depth, sky_depth_def), conf -> 1
    non_sky_max = min(float(np.quantile(_sample_for_quantile(depth[non_sky]), 0.99)),
                      sky_depth_def)
    depth[~non_sky] = non_sky_max
    if conf is not None:
        conf[~non_sky] = 1.0

    return NestedPrediction(depth=depth, conf=conf, extrinsics=extr, intrinsics=pred.intrinsics,
                            processed_images=pred.processed_images, gaussians=pred.gaussians,
                            is_metric=1, scale_factor=scale)


def nested_inference(anyview: DA3, metric: DA3Mono, frames: np.ndarray, attn_impl: str = "auto",
                     compute_dtype: torch.dtype = torch.bfloat16,
                     timer: Optional[StageTimer] = None) -> NestedPrediction:
    """Both branches on (S, H, W, 3) uint8 frames (sides divisible by 14),
    then the alignment (reference forward :329-366). ``timer`` (optional)
    times the stages "anyview", "metric" and "align"; give it
    ``sync=torch.cuda.synchronize`` to time the card's work."""
    timer = timer or StageTimer()
    with timer.stage("anyview"):
        pred = da3_inference(anyview, frames, attn_impl=attn_impl, compute_dtype=compute_dtype)
    with timer.stage("metric"):
        raw_metric, sky = mono_inference(metric, frames, attn_impl=attn_impl,
                                         compute_dtype=compute_dtype, sky_postprocess=False)
    with timer.stage("align"):
        metric_depth = apply_metric_scaling(raw_metric, pred.intrinsics)
        return align_to_metric(pred, metric_depth, sky)

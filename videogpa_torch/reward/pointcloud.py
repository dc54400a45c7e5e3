"""Colored point cloud with confidence filtering (``videogpa_tpu/reward/pointcloud.py``).

Shapes stay fixed: the full point set comes back with a boolean keep-mask,
which the z-buffer consumes directly. ``save_ply`` writes a cloud to disk.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def confidence_mask(conf: torch.Tensor, conf_thres: float) -> torch.Tensor:
    """Keep-mask over flattened confidences. conf_thres <= 0 keeps every
    finite conf > 1e-5; otherwise the top (1 - conf_thres/100) fraction of
    the valid points (>= the k-th largest value), the k-th found by a sort."""
    vals = conf.reshape(-1)
    valid = torch.isfinite(vals) & (vals > 1e-5)
    if conf_thres <= 0:
        return valid
    keep_frac = max(0.0, min(1.0, 1.0 - conf_thres / 100.0))
    n_valid = valid.sum()
    k = torch.clamp(torch.ceil(n_valid * keep_frac).to(torch.int64), min=1)
    sorted_vals = torch.sort(torch.where(valid, vals, -torch.inf), descending=True).values
    thr = sorted_vals[torch.clamp(k - 1, min=0)]
    return valid & (vals >= thr)


def colored_pointcloud(predictions: Dict[str, torch.Tensor], mode: str = "depth",
                       conf_thres: float = 0.0
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(points (N, 3), colors (N, 3) in [0, 255], keep-mask (N,)) from
    world_points_from_depth / world_points (+ conf) and images (S, 3, H, W)
    in [0, 1]."""
    if "pointmap" in mode.lower() and "world_points" in predictions:
        points = predictions["world_points"]
        conf = predictions.get("world_points_conf")
    else:
        points = predictions["world_points_from_depth"]
        conf = predictions.get("depth_conf")
    if conf is None:
        conf = torch.ones(points.shape[:-1], device=points.device)
    images = predictions["images"]
    if images.dim() == 4 and images.shape[1] == 3:
        images = images.permute(0, 2, 3, 1)
    colors = images.reshape(-1, 3) * 255.0
    return points.reshape(-1, 3), colors, confidence_mask(conf, conf_thres)


def save_ply(points, colors, path: str) -> None:
    """Binary little-endian PLY of points (N, 3) and colors (N, 3) in [0, 255]
    (numpy arrays or tensors on any device)."""
    def host(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    P = host(points).astype(np.float32)
    C = np.clip(host(colors), 0, 255).astype(np.uint8)
    n = P.shape[0]
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    rec = np.empty(n, dtype=[("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                             ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    rec["x"], rec["y"], rec["z"] = P[:, 0], P[:, 1], P[:, 2]
    rec["red"], rec["green"], rec["blue"] = C[:, 0], C[:, 1], C[:, 2]
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())

"""Reconstruction evaluation: TSDF fusion and chamfer / F-score metrics
(``videogpa_tpu/models/da3/recon.py``).

The reference (``depth_anything_3/bench/utils.py``) fuses with Open3D's
hash-grid TSDF volume; the JAX package, and so the port, fuses into a dense
voxel grid: every frame's depth is sampled bilinearly at each voxel's
projection and averaged with the truncated-SDF weighting, and the surface is
the zero-crossing shell (|tsdf| < surface_frac). The metrics are host numpy
and scipy; the integration is plain PyTorch on the device (it is XLA code in
the JAX package).

The integration is elementwise per voxel, a frame at a time in frame order,
and runs over chunks of ``TSDF_CHUNK`` voxels: a voxel's sums and their order
are those of the whole grid at once. It spells the rotation out as sums of
products and divides by tensors, never by Python scalars (which the card
turns into products with a reciprocal), so the card and the CPU give the
same voxels bit for bit.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from videogpa_torch.device import resolve_device
from videogpa_torch.geometry import affine_inverse, unproject_depth

# voxels a chunk: ~30 temporaries of 16-32 MB each
TSDF_CHUNK = 1 << 22


# ---------------------------------------------------------------------------
# chamfer / F-score (reference bench/utils.py:72-171), host numpy
# ---------------------------------------------------------------------------

def nn_correspondance(verts1: np.ndarray, verts2: np.ndarray) -> np.ndarray:
    """Distance from each point of verts2 to its nearest neighbour in verts1."""
    if len(verts1) == 0 or len(verts2) == 0:
        return np.array([])
    from scipy.spatial import cKDTree

    dist, _ = cKDTree(verts1).query(verts2, workers=-1)
    return np.asarray(dist).reshape(-1)


def voxel_down_sample(points: np.ndarray, voxel: float) -> np.ndarray:
    """Average one point per occupied voxel (Open3D voxel_down_sample)."""
    if len(points) == 0 or voxel <= 0:
        return points
    idx = np.floor(points / voxel).astype(np.int64)
    _, inv, counts = np.unique(idx, axis=0, return_inverse=True, return_counts=True)
    sums = np.zeros((len(counts), 3), np.float64)
    np.add.at(sums, inv, points)
    return (sums / counts[:, None]).astype(points.dtype)


def evaluate_3d_reconstruction(pcd_pred: np.ndarray, pcd_trgt: np.ndarray,
                               threshold: float = 0.05,
                               down_sample: Optional[float] = None) -> Dict[str, float]:
    """acc / comp / overall chamfer and precision / recall / F-score at
    ``threshold``."""
    if down_sample is not None and down_sample > 0:
        pcd_pred = voxel_down_sample(np.asarray(pcd_pred), down_sample)
        pcd_trgt = voxel_down_sample(np.asarray(pcd_trgt), down_sample)
    if len(pcd_pred) == 0 or len(pcd_trgt) == 0:
        return {"acc": float("inf"), "comp": float("inf"), "overall": float("inf"),
                "precision": 0.0, "recall": 0.0, "fscore": 0.0}
    d_pred = nn_correspondance(pcd_trgt, pcd_pred)  # accuracy
    d_gt = nn_correspondance(pcd_pred, pcd_trgt)  # completeness
    acc = float(np.mean(d_pred))
    comp = float(np.mean(d_gt))
    precision = float(np.mean(d_pred < threshold))
    recall = float(np.mean(d_gt < threshold))
    fscore = 2 * precision * recall / (precision + recall) if precision + recall > 0 else 0.0
    return {"acc": acc, "comp": comp, "overall": (acc + comp) / 2,
            "precision": precision, "recall": recall, "fscore": fscore}


# ---------------------------------------------------------------------------
# TSDF fusion on the device
# ---------------------------------------------------------------------------

def _integrate_chunk(c: torch.Tensor, depths, intrinsics, extrinsics, trunc, max_depth):
    """(tsdf, weight) of the voxel centres c (n, 3) over every frame."""
    H, W = depths.shape[-2:]
    tsdf = torch.zeros(c.shape[0], dtype=torch.float32, device=c.device)
    weight = torch.zeros_like(tsdf)
    x, y, zw = c[:, 0], c[:, 1], c[:, 2]
    for depth, K, E in zip(depths, intrinsics, extrinsics):
        # centres @ R.T + t, one sum of products a camera axis
        cx, cy, z = ((x * E[i, 0] + y * E[i, 1]) + zw * E[i, 2] + E[i, 3] for i in range(3))
        zc = torch.clamp(z, min=1e-6)
        u = (cx / zc) * K[0, 0] + K[0, 2]
        v = (cy / zc) * K[1, 1] + K[1, 2]
        # bilinear depth lookup
        u0 = torch.floor(u).to(torch.int64).clamp(0, W - 2)
        v0 = torch.floor(v).to(torch.int64).clamp(0, H - 2)
        fu, fv = u - u0, v - v0
        d = (depth[v0, u0] * (1 - fu) * (1 - fv) + depth[v0, u0 + 1] * fu * (1 - fv)
             + depth[v0 + 1, u0] * (1 - fu) * fv + depth[v0 + 1, u0 + 1] * fu * fv)
        inb = ((u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
               & (z > 1e-4) & (d > 1e-4) & (d < max_depth))
        sdf = (d - z) / trunc
        # the standard TSDF rule: integrate only in front of the surface band
        w_new = (inb & (sdf > -1.0)).to(torch.float32)
        sdf = torch.clamp(sdf, -1.0, 1.0)
        tsdf = (tsdf * weight + sdf * w_new) / torch.clamp(weight + w_new, min=1e-6)
        weight = weight + w_new
    return tsdf, weight


def _tsdf_integrate(centers: torch.Tensor, depths: torch.Tensor, intrinsics: torch.Tensor,
                    extrinsics: torch.Tensor, trunc: float, max_depth: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """centers (N, 3) world voxel centres, depths (S, H, W), intrinsics
    (S, 3, 3), extrinsics (S, 4, 4) world->camera, all on one device ->
    (tsdf (N,), weight (N,)): the weighted-average truncated SDF, a chunk of
    ``TSDF_CHUNK`` voxels at a time."""
    trunc_t = torch.tensor(trunc, dtype=torch.float32, device=centers.device)
    parts = [_integrate_chunk(centers[i:i + TSDF_CHUNK], depths, intrinsics, extrinsics,
                              trunc_t, max_depth)
             for i in range(0, centers.shape[0], TSDF_CHUNK)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def fuse_depths_tsdf(depths: np.ndarray, intrinsics: np.ndarray, extrinsics: np.ndarray,
                     voxel_size: float = 0.04, trunc_factor: float = 4.0,
                     max_depth: float = 10.0, surface_frac: float = 0.5,
                     max_voxels: int = 48_000_000, min_weight: float = 1.0,
                     device=None) -> np.ndarray:
    """Fuse depth maps (S, H, W) with intrinsics (S, 3, 3) and world->camera
    extrinsics (S, 3 or 4, 4) into a dense TSDF grid on ``device`` (the card
    unless the caller asks for the CPU); returns the host's surface points
    (M, 3) f32. The bounds come from the 1st / 99th percentiles of the
    4x-subsampled unprojected depths, on the host; ``voxel_size`` grows
    while the grid would exceed ``max_voxels``."""
    dev = resolve_device(device)
    S = len(depths)
    if extrinsics.shape[-2] == 3:
        pad = np.tile(np.array([[0, 0, 0, 1.0]], np.float32), (S, 1, 1))
        extrinsics = np.concatenate([extrinsics, pad], axis=1)

    # drop frames with non-finite cameras or depths (degenerate predictions)
    ok = (np.isfinite(intrinsics).all((1, 2)) & np.isfinite(extrinsics).all((1, 2))
          & np.isfinite(depths).all((1, 2)))
    if not ok.all():
        depths, intrinsics, extrinsics = depths[ok], intrinsics[ok], extrinsics[ok]
    if len(depths) == 0:
        return np.zeros((0, 3), np.float32)

    # world-space bounds from subsampled unprojections
    sub_K = np.asarray(intrinsics) / np.array([4, 4, 1.0])[None, :, None]
    pts = unproject_depth(
        torch.from_numpy(np.ascontiguousarray(depths[:, ::4, ::4, None])).float()[None],
        torch.from_numpy(sub_K).float()[None],
        affine_inverse(torch.from_numpy(np.asarray(extrinsics)).float())[None],
    ).numpy().reshape(-1, 3)
    d = depths[:, ::4, ::4].reshape(-1)
    valid = (d > 1e-4) & (d < max_depth)
    if not valid.any():  # degenerate depth range: widen the truncation band
        valid = d > 1e-4
        max_depth = float(d[valid].max()) * 1.01 if valid.any() else max_depth
    if not valid.any():
        return np.zeros((0, 3), np.float32)
    pts = pts[valid]
    lo = np.percentile(pts, 1, axis=0) - 2 * voxel_size
    hi = np.percentile(pts, 99, axis=0) + 2 * voxel_size

    dims = np.ceil((hi - lo) / voxel_size).astype(int)
    while int(np.prod(dims)) > max_voxels:
        voxel_size *= 1.26  # ~2x fewer voxels a step
        dims = np.ceil((hi - lo) / voxel_size).astype(int)
    trunc = trunc_factor * voxel_size

    # each axis in float64, cast to f32, then the grid on the device: the
    # same f32 centres as the host's float64 meshgrid cast
    ax = [torch.from_numpy((lo[i] + (np.arange(dims[i]) + 0.5) * voxel_size)
                           .astype(np.float32)).to(dev) for i in range(3)]
    centers = torch.stack(torch.meshgrid(*ax, indexing="ij"), -1).reshape(-1, 3)
    tsdf, weight = _tsdf_integrate(
        centers, torch.from_numpy(np.asarray(depths, np.float32)).to(dev),
        torch.from_numpy(np.asarray(intrinsics, np.float32)).to(dev),
        torch.from_numpy(np.asarray(extrinsics, np.float32)).to(dev), float(trunc),
        float(max_depth))
    mask = (torch.abs(tsdf) < surface_frac) & (weight >= min_weight)
    return centers[mask].cpu().numpy()

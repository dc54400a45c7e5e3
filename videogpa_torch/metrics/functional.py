"""Metric functions over whole clips (``videogpa_tpu/metrics/functional.py``).

MSE/PSNR with the reference's range handling, SSIM (gaussian 11/1.5 with the
official downsampling), the camera-motion score and the multi-view depth
consistency score (MVCS), and the Epipolar metric's geometry: the normalised
8-point fundamental matrix (``find_fundamental``, SVDs in f32) and the Sampson
distance.
"""

from __future__ import annotations

from typing import Tuple

import torch

from videogpa_torch.ops import layers as L
from videogpa_torch.ops.resize import grid_sample_bilinear, resize_bilinear


def to_unit_range(x: torch.Tensor) -> torch.Tensor:
    """Frames to [0, 1]: [-1, 1] -> [0, 1]; [0, 255] -> [0, 1]."""
    lo, hi = x.min(), x.max()
    return torch.where(lo < 0, (x + 1.0) / 2.0, torch.where(hi > 1.0, x / 255.0, x))


def to_sym_range(x: torch.Tensor) -> torch.Tensor:
    """Frames to [-1, 1] (the LPIPS convention)."""
    lo, hi = x.min(), x.max()
    x01 = torch.where(hi > 1.0, x / 255.0, x)
    return torch.where(lo >= 0, x01 * 2.0 - 1.0, x)


def _match_size(gt: torch.Tensor, rep: torch.Tensor) -> torch.Tensor:
    """Resize rep (..., H, W) to gt's spatial size (bilinear, align_corners=False)."""
    if gt.shape[-2:] != rep.shape[-2:]:
        rep = resize_bilinear(rep, gt.shape[-2:], align_corners=False)
    return rep


def mse(gt: torch.Tensor, rep: torch.Tensor) -> torch.Tensor:
    """Clip MSE in [0, 1] range; gt/rep (T, C, H, W) in any supported range."""
    gt = to_unit_range(gt.float())
    rep = _match_size(gt, to_unit_range(rep.float()))
    return ((gt - rep) ** 2).mean()


def psnr(gt: torch.Tensor, rep: torch.Tensor) -> torch.Tensor:
    m = mse(gt, rep)
    return torch.where(m == 0, torch.full_like(m, 100.0),
                       10.0 * torch.log10(1.0 / torch.clamp(m, min=1e-12)))


def _gaussian_kernel1d(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def ssim(gt: torch.Tensor, rep: torch.Tensor, kernel_size: int = 11, sigma: float = 1.5,
         k1: float = 0.01, k2: float = 0.03, data_range: float = 1.0,
         downsample: bool = True) -> torch.Tensor:
    """SSIM over (T, C, H, W) in [0, 1], mean over everything: average-pool
    by f = max(1, round(min(H, W) / 256)), gaussian window, valid-mode
    statistics."""
    gt = to_unit_range(gt.float())
    rep = _match_size(gt, to_unit_range(rep.float()))
    f = max(1, round(min(gt.shape[-2], gt.shape[-1]) / 256)) if downsample else 1
    if f > 1:
        def pool(x):
            T, C, H, W = x.shape
            x = x[:, :, : H // f * f, : W // f * f]
            return x.reshape(T, C, H // f, f, W // f, f).mean(dim=(3, 5))

        gt, rep = pool(gt), pool(rep)
    g = _gaussian_kernel1d(kernel_size, sigma, gt.device)
    kh, kw = g.reshape(1, 1, kernel_size, 1), g.reshape(1, 1, 1, kernel_size)

    def blur(x):
        T, C, H, W = x.shape
        h = L.conv2d(L.conv2d(x.reshape(T * C, 1, H, W), kh), kw)
        return h.reshape(T, C, *h.shape[-2:])

    mu_x, mu_y = blur(gt), blur(rep)
    sigma_x = blur(gt * gt) - mu_x ** 2
    sigma_y = blur(rep * rep) - mu_y ** 2
    sigma_xy = blur(gt * rep) - mu_x * mu_y
    c1, c2 = (k1 * data_range) ** 2, (k2 * data_range) ** 2
    ssim_map = ((2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)) / (
        (mu_x ** 2 + mu_y ** 2 + c1) * (sigma_x + sigma_y + c2))
    return ssim_map.mean()


def motion_score(extrinsics: torch.Tensor) -> torch.Tensor:
    """Camera motion of (T, 3+, 4) extrinsics: mean ||t_{i+1} - t_i|| + 0.1 x
    mean geodesic rotation angle; NaN -> 0."""
    E = extrinsics.float()
    Rs, ts = E[:, :3, :3], E[:, :3, 3]
    trans = torch.linalg.norm(ts[1:] - ts[:-1], dim=1)
    dR = torch.einsum("tij,tkj->tik", Rs[1:], Rs[:-1])
    traces = dR.diagonal(dim1=-2, dim2=-1).sum(-1)
    angles = torch.arccos(torch.clamp((traces - 1) / 2, -1.0, 1.0))
    score = trans.mean() + 0.1 * angles.mean()
    return torch.where(torch.isnan(score), torch.zeros_like(score), score)


def mvcs(depths: torch.Tensor, intrinsics: torch.Tensor, extrinsics: torch.Tensor) -> torch.Tensor:
    """Multi-view depth consistency = exp(-mean pairwise warp error) over
    consecutive frames; 0 when no pair has a valid pixel.

    depths (T, H, W); intrinsics (T, 3, 3); extrinsics (T, 4, 4) world->camera.
    """
    depths = depths.float()
    T, H, W = depths.shape
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=depths.device),
                            torch.arange(W, dtype=torch.float32, device=depths.device),
                            indexing="ij")
    coords = torch.stack([xx, yy, torch.ones_like(xx)], dim=0).reshape(3, -1)
    # inv_ex: no error check, so no host sync (singular input gives inf/nan,
    # as jnp.linalg.inv does)
    inv_K = torch.linalg.inv_ex(intrinsics).inverse
    inv_E = torch.linalg.inv_ex(extrinsics).inverse
    errs, valids = [], []
    for i in range(T - 1):
        p3d_i = (inv_K[i] @ coords) * depths[i].reshape(1, -1)
        rel = extrinsics[i + 1] @ inv_E[i]
        p3d_j = rel[:3, :3] @ p3d_i + rel[:3, 3:4]
        proj = intrinsics[i + 1] @ p3d_j
        depth_proj = p3d_j[2].reshape(H, W)
        z = torch.clamp(proj[2], min=1e-8)
        u = (proj[0] / z).reshape(H, W)
        v = (proj[1] / z).reshape(H, W)
        sampled = grid_sample_bilinear(depths[i + 1], u, v)
        mask = (u >= 0) & (u < W) & (v >= 0) & (v < H) & (depth_proj > 0)
        cnt = mask.sum()
        errs.append(torch.where(mask, (sampled - depth_proj) ** 2, 0.0).sum()
                    / torch.clamp(cnt, min=1))
        valids.append(cnt > 0)
    errs, valids = torch.stack(errs), torch.stack(valids)
    n_valid = valids.sum()
    avg = torch.where(valids, errs, 0.0).sum() / torch.clamp(n_valid, min=1)
    return torch.where(n_valid > 0, torch.exp(-avg), torch.zeros_like(avg))


# ---------------------------------------------------------------------------
# Epipolar geometry (8-point fundamental + Sampson distance)
# ---------------------------------------------------------------------------

def _normalize_points(pts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hartley normalisation: centroid to origin, mean distance sqrt(2)."""
    mean = pts.mean(dim=0)
    d = torch.linalg.norm(pts - mean, dim=1)
    scale = (2.0 ** 0.5) / torch.clamp(d.mean(), min=1e-8)
    zero, one = torch.zeros_like(scale), torch.ones_like(scale)
    T = torch.stack([
        torch.stack([scale, zero, -scale * mean[0]]),
        torch.stack([zero, scale, -scale * mean[1]]),
        torch.stack([zero, zero, one]),
    ])
    return (pts - mean) * scale, T


def find_fundamental(pts1: torch.Tensor, pts2: torch.Tensor) -> torch.Tensor:
    """Normalised 8-point least-squares fundamental matrix, unit Frobenius
    norm, in f32. pts: (N, 2). Defined up to sign, as any SVD null vector."""
    p1, T1 = _normalize_points(pts1.float())
    p2, T2 = _normalize_points(pts2.float())
    x1, y1 = p1[:, 0], p1[:, 1]
    x2, y2 = p2[:, 0], p2[:, 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], dim=-1)
    _, _, vt = torch.linalg.svd(A, full_matrices=False)
    F = vt[-1].reshape(3, 3)
    # rank-2 enforcement
    u, s, vt2 = torch.linalg.svd(F)
    s = torch.cat([s[:2], s.new_zeros(1)])
    F = T2.T @ ((u * s[None]) @ vt2) @ T1
    return F / torch.clamp(torch.linalg.norm(F), min=1e-12)


def sampson_distance(pts1: torch.Tensor, pts2: torch.Tensor, F: torch.Tensor,
                     squared: bool = True) -> torch.Tensor:
    """Sampson epipolar distance per correspondence. pts: (N, 2)."""
    ones = pts1.new_ones((pts1.shape[0], 1))
    x1 = torch.cat([pts1, ones], dim=1)
    x2 = torch.cat([pts2, ones], dim=1)
    Fx1 = x1 @ F.T  # (N, 3) = F @ x1
    Ftx2 = x2 @ F  # (N, 3) = F^T @ x2
    num = (x2 * Fx1).sum(dim=1) ** 2
    den = Fx1[:, 0] ** 2 + Fx1[:, 1] ** 2 + Ftx2[:, 0] ** 2 + Ftx2[:, 1] ** 2
    d2 = num / torch.clamp(den, min=1e-12)
    return d2 if squared else torch.sqrt(d2 + 1e-8)

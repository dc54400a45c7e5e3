"""SE(3) inverses and depth unprojection (``videogpa_tpu/geometry/transforms.py``).

OpenCV cameras; extrinsics are world->camera [R|t].
"""

from __future__ import annotations

from typing import Optional

import torch


def closed_form_inverse_se3(se3: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) or (..., 4, 4) world->camera -> (..., 4, 4) camera->world
    [R^T | -R^T t]."""
    R = se3[..., :3, :3]
    t = se3[..., :3, 3:4]
    Rt = R.transpose(-1, -2)
    top = torch.cat([Rt, -Rt @ t], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=se3.dtype, device=se3.device)
    return torch.cat([top, bottom.expand(top.shape[:-2] + (1, 4))], dim=-2)


def affine_inverse(A: torch.Tensor) -> torch.Tensor:
    """Invert (..., 4, 4) rigid transforms keeping the bottom row as it is;
    on (..., 3, 4) input the result is (..., 3, 4) (DA3's c2w <-> w2c)."""
    R = A[..., :3, :3]
    T = A[..., :3, 3:]
    Rt = R.transpose(-1, -2)
    return torch.cat([torch.cat([Rt, -Rt @ T], dim=-1), A[..., 3:, :]], dim=-2)


def _pixel_grid(H: int, W: int, dtype, device) -> torch.Tensor:
    """(H, W, 2) grid of (u, v) pixel coordinates."""
    v, u = torch.meshgrid(torch.arange(H, dtype=dtype, device=device),
                          torch.arange(W, dtype=dtype, device=device), indexing="ij")
    return torch.stack([u, v], dim=-1)


def depth_to_cam_points(depth: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """Depth (..., H, W) + K (..., 3, 3) -> camera points (..., H, W, 3)."""
    H, W = depth.shape[-2:]
    grid = _pixel_grid(H, W, depth.dtype, depth.device)
    fu = intrinsics[..., 0, 0][..., None, None]
    fv = intrinsics[..., 1, 1][..., None, None]
    cu = intrinsics[..., 0, 2][..., None, None]
    cv = intrinsics[..., 1, 2][..., None, None]
    x = (grid[..., 0] - cu) * depth / fu
    y = (grid[..., 1] - cv) * depth / fv
    return torch.stack([x, y, depth], dim=-1)


def depth_to_world_points(depth: torch.Tensor, extrinsics: torch.Tensor,
                          intrinsics: torch.Tensor) -> torch.Tensor:
    """Depth (..., H, W) + world->camera (..., 3, 4) + K (..., 3, 3) -> world
    points (..., H, W, 3), f32."""
    cam = depth_to_cam_points(depth, intrinsics).float()
    c2w = closed_form_inverse_se3(extrinsics).float()
    t = c2w[..., None, None, :3, 3]
    return torch.einsum("...hwj,...ij->...hwi", cam, c2w[..., :3, :3]) + t


def unproject_depth(depth: torch.Tensor, intrinsics: torch.Tensor,
                    c2w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DA3-convention unprojection: depth (b, v, h, w, 1), K (b, v, 3, 3),
    camera->world (b, v, 4, 4) (identity if None) -> (b, v, h, w, 3)."""
    b, v, h, w, _ = depth.shape
    if c2w is None:
        c2w = torch.eye(4, dtype=depth.dtype, device=depth.device).expand(b, v, 4, 4)
    grid = _pixel_grid(h, w, depth.dtype, depth.device)
    pix = torch.cat([grid, torch.ones((h, w, 1), dtype=depth.dtype, device=depth.device)], -1)
    rays = torch.einsum("bvij,hwj->bvhwi", torch.linalg.inv(intrinsics), pix)
    cam = rays * depth
    return (torch.einsum("bvij,bvhwj->bvhwi", c2w[..., :3, :3], cam)
            + c2w[..., :3, 3][:, :, None, None, :])

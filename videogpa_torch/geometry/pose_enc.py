"""9-D "absT_quaR_FoV" pose encoding <-> extrinsics + intrinsics
(``videogpa_tpu/geometry/pose_enc.py``).

enc[..., 0:3] is the camera-from-world translation, enc[..., 3:7] the
scalar-last rotation quaternion, enc[..., 7:9] (fov_h, fov_w) in radians.
OpenCV cameras; the principal point sits at the image centre.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from videogpa_torch.geometry.rotation import mat_to_quat, quat_to_mat


def extri_intri_to_pose_encoding(extrinsics: torch.Tensor, intrinsics: torch.Tensor,
                                 image_size_hw: Tuple[int, int]) -> torch.Tensor:
    """(..., 3, 4) extrinsics + (..., 3, 3) K -> (..., 9) f32 encoding."""
    H, W = image_size_hw
    fov_h = 2 * torch.atan((H / 2) / intrinsics[..., 1, 1])
    fov_w = 2 * torch.atan((W / 2) / intrinsics[..., 0, 0])
    return torch.cat([extrinsics[..., :3, 3], mat_to_quat(extrinsics[..., :3, :3]),
                      fov_h[..., None], fov_w[..., None]], dim=-1).float()


def pose_encoding_to_extri_intri(
    pose_encoding: torch.Tensor,
    image_size_hw: Tuple[int, int],
    build_intrinsics: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(..., 9) encoding -> ((..., 3, 4) world->camera extrinsics, (..., 3, 3) K)."""
    T = pose_encoding[..., :3]
    quat = pose_encoding[..., 3:7]
    fov_h = pose_encoding[..., 7]
    fov_w = pose_encoding[..., 8]
    extrinsics = torch.cat([quat_to_mat(quat), T[..., None]], dim=-1)
    if not build_intrinsics:
        return extrinsics, None
    H, W = image_size_hw
    fy = (H / 2.0) / torch.tan(fov_h / 2.0)
    fx = (W / 2.0) / torch.tan(fov_w / 2.0)
    zeros, ones = torch.zeros_like(fx), torch.ones_like(fx)
    intrinsics = torch.stack([
        torch.stack([fx, zeros, ones * (W / 2)], dim=-1),
        torch.stack([zeros, fy, ones * (H / 2)], dim=-1),
        torch.stack([zeros, zeros, ones], dim=-1),
    ], dim=-2)
    return extrinsics, intrinsics

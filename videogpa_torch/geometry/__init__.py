"""Geometry of the reward scorer: pose decoding, depth unprojection and the
z-buffer reprojection, with the hand-written scatter-min kernel (K5)."""

from videogpa_torch.geometry.pose_enc import (
    extri_intri_to_pose_encoding, pose_encoding_to_extri_intri)
from videogpa_torch.geometry.projection import (
    batch_reproject,
    project_points_zbuffer,
    project_points_zbuffer_sorted,
    reproject_views_packed,
)
from videogpa_torch.geometry.rotation import mat_to_quat, quat_to_mat, standardize_quaternion
from videogpa_torch.geometry.transforms import (
    affine_inverse,
    closed_form_inverse_se3,
    depth_to_cam_points,
    depth_to_world_points,
    unproject_depth,
)
from videogpa_torch.geometry.zbuffer_kernel import scatter_min_u32

__all__ = [
    "affine_inverse",
    "batch_reproject",
    "closed_form_inverse_se3",
    "depth_to_cam_points",
    "depth_to_world_points",
    "extri_intri_to_pose_encoding",
    "mat_to_quat",
    "pose_encoding_to_extri_intri",
    "project_points_zbuffer",
    "project_points_zbuffer_sorted",
    "quat_to_mat",
    "reproject_views_packed",
    "scatter_min_u32",
    "standardize_quaternion",
    "unproject_depth",
]

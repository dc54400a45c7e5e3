"""Quaternion -> rotation matrix, scalar-last (``videogpa_tpu/geometry/rotation.py``)."""

from __future__ import annotations

import torch


def quat_to_mat(quaternions: torch.Tensor) -> torch.Tensor:
    """Scalar-last (i, j, k, r) quaternions (..., 4) -> rotation matrices (..., 3, 3)."""
    i, j, k, r = quaternions.unbind(-1)
    two_s = 2.0 / (quaternions * quaternions).sum(-1)
    o = torch.stack(
        (
            1 - two_s * (j * j + k * k),
            two_s * (i * j - k * r),
            two_s * (i * k + j * r),
            two_s * (i * j + k * r),
            1 - two_s * (i * i + k * k),
            two_s * (j * k - i * r),
            two_s * (i * k - j * r),
            two_s * (j * k + i * r),
            1 - two_s * (i * i + j * j),
        ),
        dim=-1,
    )
    return o.reshape(quaternions.shape[:-1] + (3, 3))

"""Quaternion <-> rotation matrix, scalar-last (``videogpa_tpu/geometry/rotation.py``)."""

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


def _sqrt_positive_part(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(0, x)) with a zero subgradient at x == 0."""
    safe = torch.where(x > 0, x, torch.ones_like(x))
    return torch.where(x > 0, torch.sqrt(safe), torch.zeros_like(x))


def standardize_quaternion(quaternions: torch.Tensor) -> torch.Tensor:
    """Flip the sign so that the (scalar-last) real part is non-negative."""
    return torch.where(quaternions[..., 3:4] < 0, -quaternions, quaternions)


def mat_to_quat(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> scalar-last quaternions (..., 4): one
    candidate quaternion per component, the best-conditioned one (largest
    |q| denominator) kept."""
    m = matrix.reshape(matrix.shape[:-2] + (9,))
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = m.unbind(-1)
    q_abs = _sqrt_positive_part(torch.stack([
        1.0 + m00 + m11 + m22,
        1.0 + m00 - m11 - m22,
        1.0 - m00 + m11 - m22,
        1.0 - m00 - m11 + m22,
    ], dim=-1))
    # candidates in rijk order, each scaled by one of r, i, j, k
    quat_by_rijk = torch.stack([
        torch.stack([q_abs[..., 0] ** 2, m21 - m12, m02 - m20, m10 - m01], dim=-1),
        torch.stack([m21 - m12, q_abs[..., 1] ** 2, m10 + m01, m02 + m20], dim=-1),
        torch.stack([m02 - m20, m10 + m01, q_abs[..., 2] ** 2, m12 + m21], dim=-1),
        torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs[..., 3] ** 2], dim=-1),
    ], dim=-2)
    flr = torch.tensor(0.1, dtype=q_abs.dtype, device=q_abs.device)
    candidates = quat_by_rijk / (2.0 * torch.maximum(q_abs[..., None], flr))
    best = q_abs.argmax(dim=-1)
    out = torch.take_along_dim(candidates, best[..., None, None], dim=-2)[..., 0, :]
    return standardize_quaternion(out[..., [1, 2, 3, 0]])  # rijk -> ijkr

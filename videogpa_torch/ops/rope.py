"""Rotary position embeddings (``videogpa_tpu/ops/rope.py``): 3D for the video
DiTs (:68-128), 2D for the VGGT/DINOv2 ViTs (``rope_2d``, :41-65).

The head dim splits into temporal/vertical/horizontal channel groups
(hd/4, 3hd/8, 3hd/8); angles use the interleaved layout (each angle repeated
for its (even, odd) channel pair), diffusers' ``get_3d_rotary_pos_embed`` with
``repeat_interleave_real=True``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def rope_3d_freqs(
    grid_tfw: Tuple[int, int, int],
    head_dim: int,
    theta: float = 10000.0,
    axis_dims: Optional[Tuple[int, int, int]] = None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin), each (T*H*W, head_dim) float32."""
    T, H, W = grid_tfw
    if axis_dims is None:
        axis_dims = (head_dim // 4, head_dim // 8 * 3, head_dim // 8 * 3)
    dim_t, dim_h, dim_w = axis_dims

    def axis_angles(n, dim):
        exponents = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
        inv = 1.0 / (theta ** exponents)
        ang = torch.arange(n, dtype=torch.float32, device=device)[:, None] * inv
        return torch.repeat_interleave(ang, 2, dim=-1)  # (n, dim)

    ang_t = axis_angles(T, dim_t)
    ang_h = axis_angles(H, dim_h)
    ang_w = axis_angles(W, dim_w)
    full = torch.cat(
        [
            ang_t[:, None, None, :].expand(T, H, W, dim_t),
            ang_h[None, :, None, :].expand(T, H, W, dim_h),
            ang_w[None, None, :, :].expand(T, H, W, dim_w),
        ],
        dim=-1,
    ).reshape(T * H * W, head_dim)
    return torch.cos(full), torch.sin(full)


def rotate_interleaved(x: torch.Tensor) -> torch.Tensor:
    """(x0, x1, x2, x3, ...) -> (-x1, x0, -x3, x2, ...)."""
    pairs = x.reshape(x.shape[:-1] + (-1, 2))
    return torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).reshape(x.shape)


def apply_rope_interleaved(tokens: torch.Tensor, cos: torch.Tensor,
                           sin: torch.Tensor) -> torch.Tensor:
    """tokens (..., N, D) with interleaved tables broadcastable to them; f32 math."""
    t = tokens.float()
    return (t * cos + rotate_interleaved(t) * sin).to(tokens.dtype)


def _angles_1d(positions: torch.Tensor, dim: int, base: float) -> torch.Tensor:
    """positions (...,) -> rotate-half (duplicated) angles (..., dim)."""
    exponents = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim
    inv_freq = 1.0 / (base ** exponents)
    ang = positions[..., None].float() * inv_freq
    return torch.cat([ang, ang], dim=-1)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """(x1, x2) halves -> (-x2, x1)."""
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope_1d(tokens: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """tokens (..., N, d) rotated by rotate-half angles broadcastable to them; f32 math."""
    t = tokens.float()
    return (t * torch.cos(angles) + rotate_half(t) * torch.sin(angles)).to(tokens.dtype)


def apply_rope_cos_sin(tokens: torch.Tensor, cos: torch.Tensor,
                       sin: torch.Tensor) -> torch.Tensor:
    """The rotate-half form with precomputed tables: tokens (..., N, D),
    tables (N, D); f32 math."""
    t = tokens.float()
    return (t * cos + rotate_half(t) * sin).to(tokens.dtype)


def rope_2d(tokens: torch.Tensor, positions: torch.Tensor, base: float = 100.0,
            layout: str = "bhnd") -> torch.Tensor:
    """2D RoPE of the VGGT/DINOv2 ViTs (``videogpa_tpu/ops/rope.py:41-65``).

    tokens (B, H, N, D), or (B, N, H, D) with ``layout="bnhd"``; positions
    (B, N, 2) integer (y, x). The first half of D rotates by y, the second by
    x, each in the rotate-half (split, not interleaved) form; f32 math.
    """
    half = tokens.shape[-1] // 2
    ang_y = _angles_1d(positions[..., 0], half, base)  # (B, N, half)
    ang_x = _angles_1d(positions[..., 1], half, base)
    if layout == "bnhd":
        ang_y, ang_x = ang_y[:, :, None], ang_x[:, :, None]
    else:
        ang_y, ang_x = ang_y[:, None], ang_x[:, None]
    return torch.cat([apply_rope_1d(tokens[..., :half], ang_y),
                      apply_rope_1d(tokens[..., half:], ang_x)], dim=-1)

"""Flow-matching utilities for Wan2.2 (shifted linear schedule)
(``videogpa_tpu/models/wan/flow_match.py``).

    sigma(t)   = shift * s / (1 + (shift - 1) * s),  s = t / T
    z_t        = (1 - sigma) * z0 + sigma * eps
    target v   = eps - z0
    TI2V trick = the first temporal latent frame is the clean image latent
                 (sigma = 0), expressed through a per-token timestep tensor
                 where first-frame tokens carry t = 0.
"""

from __future__ import annotations

from typing import Tuple

import torch


def sigma_from_timestep(timestep: torch.Tensor, num_train_timesteps: int = 1000,
                        shift: float = 5.0) -> torch.Tensor:
    s = timestep.float() / num_train_timesteps
    return shift * s / (1 + (shift - 1) * s)


def flow_add_noise(z0: torch.Tensor, noise: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    sigma = sigma.reshape(sigma.shape + (1,) * (z0.ndim - sigma.ndim))
    return (1.0 - sigma) * z0 + sigma * noise


def flow_velocity_target(z0: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    return noise - z0


def ti2v_timestep_tokens(
    timestep: torch.Tensor,
    grid_fhw: Tuple[int, int, int],
    patch_size: Tuple[int, int, int] = (1, 2, 2),
) -> torch.Tensor:
    """Per-token timesteps: first latent frame's tokens get t=0, rest get t.

    Args:
        timestep: (B,) timesteps.
        grid_fhw: latent grid (F, H, W) BEFORE patching.

    Returns:
        (B, L) float32 with L = F * H/p * W/p.
    """
    F, H, W = grid_fhw
    hp, wp = H // patch_size[1], W // patch_size[2]
    per_frame = torch.ones((F,), dtype=torch.float32, device=timestep.device)
    per_frame[0] = 0.0
    tokens = per_frame.repeat_interleave(hp * wp)  # (L,)
    return timestep.float()[:, None] * tokens[None]

"""Wan2.2 TI2V-5B video diffusion family in PyTorch
(``videogpa_tpu/models/wan``): WanModel DiT (self-attn + text cross-attn,
per-token timesteps), the shifted flow-matching schedule and the TI2V denoise
loop. The Wan VAE, ``sample_ti2v`` and the checkpoint conversion come with
the VAE and loader slices.
"""

from videogpa_torch.models.wan.config import WanConfig
from videogpa_torch.models.wan.dit import WanTransformer, wan_forward, wan_init
from videogpa_torch.models.wan.flow_match import (
    flow_add_noise,
    flow_velocity_target,
    sigma_from_timestep,
    ti2v_timestep_tokens,
)
from videogpa_torch.models.wan.pipeline import (
    sample_ti2v,
    shifted_sigmas,
    unipc_loop,
    wan_denoise_loop,
)

__all__ = [
    "WanConfig",
    "WanTransformer",
    "wan_init",
    "wan_forward",
    "sigma_from_timestep",
    "flow_add_noise",
    "flow_velocity_target",
    "ti2v_timestep_tokens",
    "shifted_sigmas",
    "unipc_loop",
    "wan_denoise_loop",
    "sample_ti2v",
]

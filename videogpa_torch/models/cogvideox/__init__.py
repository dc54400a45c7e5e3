"""CogVideoX video diffusion family in PyTorch: DiT, scheduler, 3D-causal VAE
and the sampling pipelines."""

from videogpa_torch.models.cogvideox.config import CogVideoXConfig
from videogpa_torch.models.cogvideox.dit import CogVideoXTransformer, dit_forward, dit_init
from videogpa_torch.models.cogvideox.pipeline import (
    SamplerSettings, decode_latents, denoise_loop, num_latent_frames, sample_i2v, sample_t2v,
    video_to_uint8)
from videogpa_torch.models.cogvideox.scheduler import CogVideoXScheduler
from videogpa_torch.models.cogvideox.vae import (
    CogVideoXVAE, vae_decode, vae_decode_tiled, vae_encode, vae_encode_tiled, vae_init)

__all__ = [
    "CogVideoXConfig", "CogVideoXTransformer", "dit_init", "dit_forward",
    "CogVideoXScheduler", "SamplerSettings", "denoise_loop", "num_latent_frames", "sample_t2v",
    "sample_i2v", "decode_latents", "video_to_uint8", "CogVideoXVAE", "vae_init", "vae_encode",
    "vae_decode", "vae_encode_tiled", "vae_decode_tiled",
]

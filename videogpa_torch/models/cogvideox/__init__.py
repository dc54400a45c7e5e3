"""CogVideoX video diffusion family in PyTorch: DiT, scheduler, denoise loop."""

from videogpa_torch.models.cogvideox.config import CogVideoXConfig
from videogpa_torch.models.cogvideox.dit import CogVideoXTransformer, dit_forward, dit_init
from videogpa_torch.models.cogvideox.pipeline import SamplerSettings, denoise_loop
from videogpa_torch.models.cogvideox.scheduler import CogVideoXScheduler

__all__ = [
    "CogVideoXConfig", "CogVideoXTransformer", "dit_init", "dit_forward",
    "CogVideoXScheduler", "SamplerSettings", "denoise_loop",
]

"""CogVideoX model configurations.

Variants mirror the published diffusers configs of the four reference recipes
(reference ``generate/CogVideoX-5B.py``, ``-5B-I2V``, ``1.5-5B`` and
``train/CogVideoX*/03_train.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CogVideoXConfig:
    # DiT
    num_layers: int = 42
    num_heads: int = 48
    head_dim: int = 64
    in_channels: int = 16
    out_channels: int = 16
    text_embed_dim: int = 4096
    time_embed_dim: int = 512
    patch_size: int = 2
    patch_size_t: Optional[int] = None  # 1.5 models: 2
    max_text_seq_length: int = 226
    use_rotary_positional_embeddings: bool = True
    use_learned_positional_embeddings: bool = False
    ofs_embed_dim: Optional[int] = None  # 1.5 I2V: 512
    rope_theta: float = 10000.0
    # default sample grid (latent space)
    sample_frames: int = 13  # 49 pixel frames -> (49-1)/4+1
    sample_height: int = 60
    sample_width: int = 90
    # VAE
    vae_latent_channels: int = 16
    vae_block_out_channels: Tuple[int, ...] = (128, 256, 256, 512)
    vae_layers_per_block: int = 3
    vae_scaling_factor: float = 1.15258426
    vae_invert_scale_latents: bool = False  # 1.5 models: True
    temporal_compression_ratio: int = 4
    spatial_compression_ratio: int = 8

    @property
    def hidden_dim(self) -> int:
        return self.num_heads * self.head_dim

    # ------------------------------------------------------------------
    # Presets
    # ------------------------------------------------------------------

    @staticmethod
    def cogvideox_5b() -> "CogVideoXConfig":
        return CogVideoXConfig()

    @staticmethod
    def cogvideox_5b_i2v() -> "CogVideoXConfig":
        return CogVideoXConfig(
            in_channels=32, use_learned_positional_embeddings=True
        )

    @staticmethod
    def cogvideox_2b() -> "CogVideoXConfig":
        return CogVideoXConfig(
            num_layers=30,
            num_heads=30,
            use_rotary_positional_embeddings=False,
        )

    @staticmethod
    def cogvideox_1_5_5b() -> "CogVideoXConfig":
        return CogVideoXConfig(
            patch_size_t=2,
            sample_height=96,
            sample_width=170,
            sample_frames=21,  # (81-1)/4+1
            vae_invert_scale_latents=True,
        )

    @staticmethod
    def tiny(i2v: bool = False) -> "CogVideoXConfig":
        return CogVideoXConfig(
            num_layers=2,
            num_heads=2,
            head_dim=16,
            in_channels=8 if i2v else 4,
            out_channels=4,
            text_embed_dim=32,
            time_embed_dim=16,
            max_text_seq_length=8,
            sample_frames=3,
            sample_height=8,
            sample_width=12,
            vae_latent_channels=4,
            vae_block_out_channels=(8, 16, 16, 32),
            vae_layers_per_block=1,
        )

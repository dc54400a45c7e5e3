"""Wan model configurations (``videogpa_tpu/models/wan/config.py``, copied).

ti2v_5b mirrors the Wan2.2-TI2V-5B dims documented at reference
``train/Wan2.2-TI2V-5B/03_train.py:9-14,90-96``: 30 layers, dim 3072,
in/out 48 channels, VAE z=48 stride (4,16,16), patch (1,2,2), umT5 context
dim 4096, flow-matching shift 5.0.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class WanConfig:
    num_layers: int = 30
    dim: int = 3072
    ffn_dim: int = 14336
    num_heads: int = 24  # head_dim 128
    in_channels: int = 48
    out_channels: int = 48
    text_dim: int = 4096
    text_len: int = 512
    freq_dim: int = 256
    patch_size: Tuple[int, int, int] = (1, 2, 2)
    rope_theta: float = 10000.0
    eps: float = 1e-6
    # VAE (Wan2.2 vae2_2.py operating point: z=48, stride (4,16,16),
    # encoder base 160 / decoder base 256, 2x2 input patchify)
    vae_z_dim: int = 48
    vae_stride: Tuple[int, int, int] = (4, 16, 16)
    vae_base_ch: int = 160
    vae_dec_base_ch: int = 256
    vae_patch_size: int = 2
    vae_dim_mult: Tuple[int, ...] = (1, 2, 4, 4)
    vae_num_res_blocks: int = 2
    vae_temporal_down: Tuple[bool, ...] = (False, True, True)
    # flow matching
    num_train_timesteps: int = 1000
    shift: float = 5.0

    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    @property
    def rope_axis_dims(self) -> Tuple[int, int, int]:
        """Wan split: d - 4*(d//6) temporal, 2*(d//6) each spatial."""
        d = self.head_dim
        s = 2 * (d // 6)
        return (d - 2 * s, s, s)

    @staticmethod
    def ti2v_5b() -> "WanConfig":
        return WanConfig()

    @staticmethod
    def tiny() -> "WanConfig":
        return WanConfig(
            num_layers=2,
            dim=48,
            ffn_dim=96,
            num_heads=2,  # head_dim 24
            in_channels=6,
            out_channels=6,
            text_dim=32,
            text_len=16,
            freq_dim=16,
            vae_z_dim=6,
            vae_base_ch=8,
            vae_dec_base_ch=8,
        )

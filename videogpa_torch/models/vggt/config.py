"""VGGT configuration (a copy of ``videogpa_tpu/models/vggt/config.py``).

Defaults mirror facebook/VGGT-1B (reference ``vggt/models/aggregator.py:54-76``,
``vggt/models/vggt.py:19-28``): DINOv2 ViT-L/14 patch embed, 24 frame + 24
global alternating blocks at dim 1024, QK-norm, 2D RoPE base 100, LayerScale
0.01, 4 register tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class VGGTConfig:
    img_size: int = 518
    patch_size: int = 14

    # DINOv2 patch-embed backbone (ViT-L/14 with registers)
    backbone_dim: int = 1024
    backbone_depth: int = 24
    backbone_heads: int = 16
    backbone_register_tokens: int = 4
    backbone_init_values: float = 1.0

    # Alternating-attention aggregator
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    num_register_tokens: int = 4
    qk_norm: bool = True
    rope_base: float = 100.0
    init_values: float = 0.01

    # Heads
    enable_camera: bool = True
    enable_depth: bool = True
    enable_point: bool = True
    camera_trunk_depth: int = 4
    camera_iterations: int = 4
    dpt_features: int = 256
    dpt_out_channels: Tuple[int, int, int, int] = (256, 512, 1024, 1024)
    dpt_intermediate_layers: Tuple[int, int, int, int] = (4, 11, 17, 23)

    @property
    def patch_start_idx(self) -> int:
        return 1 + self.num_register_tokens

    @property
    def tokens_dim(self) -> int:
        """Aggregator output channel dim: concat [frame || global]."""
        return 2 * self.embed_dim

    @staticmethod
    def tiny() -> "VGGTConfig":
        """Small config for CPU tests (shapes only, not weights-compatible)."""
        return VGGTConfig(
            img_size=56,
            patch_size=14,
            backbone_dim=32,
            backbone_depth=2,
            backbone_heads=2,
            embed_dim=32,
            depth=4,
            num_heads=2,
            camera_trunk_depth=2,
            camera_iterations=2,
            dpt_features=16,
            dpt_out_channels=(16, 32, 32, 32),
            dpt_intermediate_layers=(0, 1, 2, 3),
        )

"""DA3 configuration and model presets (``videogpa_tpu/models/da3/config.py``).

Mirrors the reference preset registry (``depth_anything_3/cfg.py:31-100``,
``configs/*.yaml``): da3-{small,base,large,giant} multi-view nets,
da3{mono,metric}-large single-view nets, and the nested
``da3nested-giant-large`` (anyview giant + metric large). Backbone dims come
from ``model/dinov2/vision_transformer.py:401-456`` (vit_small/base/large/
giant2 — giant2 uses SwiGLU FFN per ``model/dinov2/dinov2.py:48``), head
dims from each yaml's ``head`` block.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class DA3Config:
    img_size: int = 518
    patch_size: int = 14
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    init_values: float = 1.0  # DINOv2 LayerScale
    ffn: str = "mlp"  # vitg backbones use "swiglu" (SwiGLUFFNFused)
    alt_start: int = 8
    out_layers: Tuple[int, ...] = (11, 15, 19, 23)
    rope_base: float = 100.0
    ref_view_threshold: int = 3  # S >= 3 triggers reference-view selection
    # first | middle | saddle_balanced | saddle_sim_range
    # (reference model/reference_view_selector.py:29-110)
    ref_view_strategy: str = "saddle_balanced"

    # DualDPT
    dpt_features: int = 256
    dpt_out_channels: Tuple[int, int, int, int] = (256, 512, 1024, 1024)
    aux_out1_conv_num: int = 5

    @property
    def tokens_dim(self) -> int:
        return 2 * self.embed_dim  # cat_token: [local ‖ global]

    @staticmethod
    def small() -> "DA3Config":
        """da3-small: ViT-S backbone (configs/da3-small.yaml)."""
        return DA3Config(
            embed_dim=384, depth=12, num_heads=6, alt_start=4,
            out_layers=(5, 7, 9, 11),
            dpt_features=64, dpt_out_channels=(48, 96, 192, 384),
        )

    @staticmethod
    def base() -> "DA3Config":
        """da3-base: ViT-B backbone (configs/da3-base.yaml)."""
        return DA3Config(
            embed_dim=768, depth=12, num_heads=12, alt_start=4,
            out_layers=(5, 7, 9, 11),
            dpt_features=128, dpt_out_channels=(96, 192, 384, 768),
        )

    @staticmethod
    def large() -> "DA3Config":
        """da3-large: ViT-L backbone (configs/da3-large.yaml)."""
        return DA3Config()

    @staticmethod
    def giant() -> "DA3Config":
        """da3-giant: ViT-g backbone w/ SwiGLU FFN (configs/da3-giant.yaml)."""
        return DA3Config(
            embed_dim=1536, depth=40, num_heads=24, ffn="swiglu", alt_start=13,
            out_layers=(19, 27, 33, 39),
            dpt_features=256, dpt_out_channels=(256, 512, 1024, 1024),
        )

    @staticmethod
    def mono_large() -> "DA3Config":
        """da3mono-large / da3metric-large trunk (alt attention off)."""
        return DA3Config(out_layers=(4, 11, 17, 23), alt_start=-1)

    @staticmethod
    def tiny() -> "DA3Config":
        return DA3Config(
            img_size=56,
            embed_dim=32,
            depth=8,
            num_heads=2,
            alt_start=2,
            out_layers=(3, 5, 7, 7),
            dpt_features=16,
            dpt_out_channels=(16, 16, 16, 16),
            aux_out1_conv_num=1,
        )

    @staticmethod
    def from_name(name: str):
        """Resolve a reference preset name (``cfg.py:31-100`` registry).

        Multi-view / mono presets return a DA3Config; the nested preset
        returns an (anyview, metric) pair, the configurations of
        ``nested.py``'s two branches (``DA3`` and ``DA3Mono``)."""
        presets = {
            "da3-small": DA3Config.small,
            "da3-base": DA3Config.base,
            "da3-large": DA3Config.large,
            "da3-giant": DA3Config.giant,
            "da3mono-large": DA3Config.mono_large,
            "da3metric-large": DA3Config.mono_large,
        }
        if name in presets:
            return presets[name]()
        if name == "da3nested-giant-large":
            return (DA3Config.giant(), DA3Config.mono_large())
        raise KeyError(
            f"unknown DA3 preset {name!r}; known: {sorted(presets) + ['da3nested-giant-large']}"
        )

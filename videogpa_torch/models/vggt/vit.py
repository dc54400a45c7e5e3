"""DINOv2 ViT-L/14 patch-embed backbone (``videogpa_tpu/models/vggt/vit.py``).

ViT with 4 register tokens, LayerScale 1.0, learned pos-embed (bicubic
antialiased interpolation when the patch grid differs); only the normed
patch tokens leave it. Its 24 blocks attend within one frame of 1 + 4 + 37^2
= 1,374 tokens at 518^2: short rows, so K4 on the card.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from videogpa_torch.models.vggt.config import VGGTConfig
from videogpa_torch.ops import layers as L
from videogpa_torch.ops.resize import resize_bicubic
from videogpa_torch.ops.transformer import Block, BlockConfig, block_apply


def block_cfg(cfg: VGGTConfig) -> BlockConfig:
    return BlockConfig(dim=cfg.backbone_dim, num_heads=cfg.backbone_heads, mlp_ratio=4.0,
                       init_values=cfg.backbone_init_values, qk_norm=False, rope_base=0.0,
                       norm_eps=1e-6)


class DinoV2(nn.Module):
    def __init__(self, cfg: VGGTConfig, device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.cfg = cfg
        C = cfg.backbone_dim
        n_patches = (cfg.img_size // cfg.patch_size) ** 2
        self.patch_embed = L.Conv2d(3, C, kernel_size=cfg.patch_size,
                                    stride=cfg.patch_size, **fk)
        self.cls_token = nn.Parameter(torch.zeros((1, 1, C), **fk))
        self.register_tokens = nn.Parameter(
            torch.zeros((1, cfg.backbone_register_tokens, C), **fk))
        self.pos_embed = nn.Parameter(torch.zeros((1, 1 + n_patches, C), **fk))
        bcfg = block_cfg(cfg)
        self.blocks = nn.ModuleList(Block(bcfg, **fk) for _ in range(cfg.backbone_depth))
        self.norm = L.LayerNorm(C, eps=1e-6, **fk)


def interpolate_pos_embed(pos_embed: torch.Tensor, h_grid: int, w_grid: int) -> torch.Tensor:
    """(1, 1 + M*M, C) learned pos-embed -> (1, 1 + h*w, C), torch-exact
    bicubic with antialias (the aggregator's DINOv2 sets it)."""
    n = pos_embed.shape[1] - 1
    m = int(round(n ** 0.5))
    if (h_grid, w_grid) == (m, m):
        return pos_embed
    patch = pos_embed[:, 1:].reshape(1, m, m, -1).permute(0, 3, 1, 2)
    patch = resize_bicubic(patch.float(), (h_grid, w_grid)).to(pos_embed.dtype)
    patch = patch.permute(0, 2, 3, 1).reshape(1, h_grid * w_grid, -1)
    return torch.cat([pos_embed[:, :1], patch], dim=1)


def dinov2_forward(model: DinoV2, images: torch.Tensor,
                   attn_impl: str = "auto") -> torch.Tensor:
    """images (B, 3, H, W), ImageNet-normalised, in the compute dtype ->
    (B, num_patches, C) normed patch tokens."""
    cfg = model.cfg
    B, _, H, W = images.shape
    hg, wg = H // cfg.patch_size, W // cfg.patch_size
    C = cfg.backbone_dim
    x = model.patch_embed(images).reshape(B, C, hg * wg).transpose(1, 2)
    cls = model.cls_token.to(x.dtype).expand(B, 1, C)
    x = torch.cat([cls, x], dim=1)
    x = x + interpolate_pos_embed(model.pos_embed, hg, wg).to(x.dtype)
    # the registers go in after the cls token, after the pos-embed add
    reg = model.register_tokens.to(x.dtype).expand(B, cfg.backbone_register_tokens, C)
    x = torch.cat([x[:, :1], reg, x[:, 1:]], dim=1)
    for blk in model.blocks:
        x = block_apply(blk, x, attn_impl=attn_impl)
    x = model.norm(x)
    return x[:, 1 + cfg.backbone_register_tokens:]

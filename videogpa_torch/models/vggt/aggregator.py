"""VGGT's alternating-attention aggregator (``videogpa_tpu/models/vggt/aggregator.py``).

Per layer, tokens pass a *frame* block (attention within each frame, tokens
(B*S, P, C): short rows, K4 on the card) then a *global* block (attention
across all frames, tokens (B, S*P, C): 13,740 keys at 10 frames of 518^2,
K1); the layer's output is concat([frame_out, global_out]) with 2C channels.
RoPE positions: the patch grid + 1, special tokens at 0.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn

from videogpa_torch.models.vggt.config import VGGTConfig
from videogpa_torch.models.vggt.vit import DinoV2, dinov2_forward
from videogpa_torch.ops.transformer import Block, BlockConfig, block_apply

_RESNET_MEAN = (0.485, 0.456, 0.406)
_RESNET_STD = (0.229, 0.224, 0.225)


def block_cfg(cfg: VGGTConfig) -> BlockConfig:
    return BlockConfig(dim=cfg.embed_dim, num_heads=cfg.num_heads, mlp_ratio=cfg.mlp_ratio,
                       qk_norm=cfg.qk_norm, init_values=cfg.init_values,
                       rope_base=cfg.rope_base)


class Aggregator(nn.Module):
    def __init__(self, cfg: VGGTConfig, device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.cfg = cfg
        self.patch_embed = DinoV2(cfg, **fk)
        self.camera_token = nn.Parameter(torch.zeros((1, 2, 1, cfg.embed_dim), **fk))
        self.register_token = nn.Parameter(
            torch.zeros((1, 2, cfg.num_register_tokens, cfg.embed_dim), **fk))
        bcfg = block_cfg(cfg)
        self.frame_blocks = nn.ModuleList(Block(bcfg, **fk) for _ in range(cfg.depth))
        self.global_blocks = nn.ModuleList(Block(bcfg, **fk) for _ in range(cfg.depth))


def slice_expand_and_flatten(token: torch.Tensor, B: int, S: int) -> torch.Tensor:
    """(1, 2, X, C) special tokens -> (B*S, X, C): slot 0 for each clip's
    first frame, slot 1 for the rest."""
    query = token[:, 0:1].expand((B, 1) + token.shape[2:])
    others = token[:, 1:].expand((B, S - 1) + token.shape[2:])
    return torch.cat([query, others], dim=1).reshape((B * S,) + token.shape[2:])


def aggregator_forward(model: Aggregator, images: torch.Tensor,
                       compute_dtype: torch.dtype = torch.float32,
                       keep_layers: Optional[Sequence[int]] = None,
                       attn_impl: str = "auto") -> Tuple[torch.Tensor, int]:
    """images (B, S, 3, H, W) in [0, 1] -> ((L, B, S, P, 2C) layer outputs,
    patch_start_idx). ``keep_layers``: keep only those layers (sorted), so
    activation memory is O(len(keep)) and not O(depth); None keeps all."""
    cfg = model.cfg
    B, S, C_in, H, W = images.shape
    mean = torch.tensor(_RESNET_MEAN, dtype=images.dtype, device=images.device)
    std = torch.tensor(_RESNET_STD, dtype=images.dtype, device=images.device)
    images = (images - mean.reshape(1, 1, 3, 1, 1)) / std.reshape(1, 1, 3, 1, 1)

    flat = images.reshape(B * S, C_in, H, W).to(compute_dtype)
    patch_tokens = dinov2_forward(model.patch_embed, flat, attn_impl)
    P_patch, C = patch_tokens.shape[1:]
    camera = slice_expand_and_flatten(model.camera_token.to(compute_dtype), B, S)
    register = slice_expand_and_flatten(model.register_token.to(compute_dtype), B, S)
    tokens = torch.cat([camera, register, patch_tokens], dim=1)
    P = tokens.shape[1]

    hg, wg = H // cfg.patch_size, W // cfg.patch_size
    yy, xx = torch.meshgrid(torch.arange(hg, device=images.device),
                            torch.arange(wg, device=images.device), indexing="ij")
    patch_pos = torch.stack([yy, xx], dim=-1).reshape(1, hg * wg, 2) + 1
    special = torch.zeros((1, cfg.patch_start_idx, 2), dtype=patch_pos.dtype,
                          device=images.device)
    pos = torch.cat([special, patch_pos], dim=1)
    pos_frame = pos.expand(B * S, P, 2)
    pos_global = pos_frame.reshape(B, S * P, 2)

    keep = set(range(cfg.depth)) if keep_layers is None else set(keep_layers)
    outs = []
    for i in range(cfg.depth):
        frame_inter = block_apply(model.frame_blocks[i], tokens, pos_frame, attn_impl)
        t = block_apply(model.global_blocks[i], frame_inter.reshape(B, S * P, C), pos_global,
                        attn_impl)
        tokens = t.reshape(B * S, P, C)
        if i in keep:
            outs.append(torch.cat([frame_inter, tokens], dim=-1).reshape(B, S, P, 2 * C))
    return torch.stack(outs), cfg.patch_start_idx

"""VGGT top-level model (``videogpa_tpu/models/vggt/model.py``).

The aggregator trunk runs in ``compute_dtype`` (bf16 on the card); the camera
head in float32; the depth and point DPT heads in ``dpt_dtype``. Only the
DPT taps and the final layer of the trunk are kept.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn as nn

from videogpa_torch.device import resolve_device
from videogpa_torch.models.vggt.aggregator import Aggregator, aggregator_forward
from videogpa_torch.models.vggt.config import VGGTConfig
from videogpa_torch.models.vggt.heads import (
    CameraHead, DPTHead, camera_head_forward, dpt_head_forward)
from videogpa_torch.ops import layers as L
from videogpa_torch.ops.transformer import LayerScale


class VGGT(nn.Module):
    """The model's parameters, named as the JAX tree of ``vggt_init``;
    ``forward`` is :func:`vggt_forward`."""

    def __init__(self, cfg: VGGTConfig, device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.cfg = cfg
        self.aggregator = Aggregator(cfg, **fk)
        self.camera_head = CameraHead(cfg, **fk) if cfg.enable_camera else None
        self.depth_head = DPTHead(cfg, output_dim=2, **fk) if cfg.enable_depth else None
        self.point_head = DPTHead(cfg, output_dim=4, **fk) if cfg.enable_point else None

    def forward(self, images: torch.Tensor, **kwargs) -> Dict[str, torch.Tensor]:
        return vggt_forward(self, images, **kwargs)


@torch.no_grad()
def vggt_init(cfg: VGGTConfig, generator: Optional[torch.Generator] = None, device=None,
              dtype: torch.dtype = torch.float32) -> VGGT:
    """Random VGGT allocated straight on ``device`` in ``dtype``, drawn as
    the JAX initialisers draw (different numbers): kaiming-uniform linears
    and convs, layer norms ones/zeros, LayerScale at its init value, the
    aggregator's camera/register tokens N(0, 1e-6), DINOv2's pos-embed
    N(0, 0.02), its cls/register tokens and the empty pose token zero.
    ``generator`` must live on ``device``; the default is seeded with 0."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    model = VGGT(cfg, device="meta", dtype=dtype).to_empty(device=device)
    L.kaiming_uniform_init_(model, generator)
    for m in model.modules():
        if isinstance(m, LayerScale):
            m.gamma.fill_(m.init_values)
    agg = model.aggregator
    agg.camera_token.normal_(0.0, 1e-6, generator=generator)
    agg.register_token.normal_(0.0, 1e-6, generator=generator)
    agg.patch_embed.pos_embed.normal_(0.0, 0.02, generator=generator)
    agg.patch_embed.cls_token.zero_()
    agg.patch_embed.register_tokens.zero_()
    if model.camera_head is not None:
        model.camera_head.empty_pose_tokens.zero_()
    return model


def vggt_forward(model: VGGT, images: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16,
                 dpt_chunk: int = 8, dpt_dtype: torch.dtype = torch.float32,
                 attn_impl: str = "auto") -> Dict[str, torch.Tensor]:
    """images (B, S, 3, H, W) or (S, 3, H, W) in [0, 1] -> dict with pose_enc
    (B, S, 9), pose_enc_list, depth (B, S, H, W, 1), depth_conf (B, S, H, W),
    world_points (B, S, H, W, 3), world_points_conf (B, S, H, W), images."""
    cfg = model.cfg
    if images.dim() == 4:
        images = images[None]
    H, W = images.shape[-2:]
    keep = tuple(sorted(set(cfg.dpt_intermediate_layers) | {cfg.depth - 1}))
    pos = {layer: i for i, layer in enumerate(keep)}
    layer_outputs, _ = aggregator_forward(model.aggregator, images, compute_dtype, keep,
                                          attn_impl)
    hcfg = dataclasses.replace(
        cfg, dpt_intermediate_layers=tuple(pos[l] for l in cfg.dpt_intermediate_layers))

    preds: Dict[str, torch.Tensor] = {"images": images}
    if model.camera_head is not None:
        cam_tokens = layer_outputs[pos[cfg.depth - 1]][:, :, 0].float()
        pose_enc_list = camera_head_forward(model.camera_head, cam_tokens, attn_impl)
        preds["pose_enc"] = pose_enc_list[-1]
        preds["pose_enc_list"] = pose_enc_list
    if model.depth_head is not None:
        preds["depth"], preds["depth_conf"] = dpt_head_forward(
            model.depth_head, layer_outputs, hcfg, (H, W), "exp", "expp1",
            chunk_size=dpt_chunk, compute_dtype=dpt_dtype)
    if model.point_head is not None:
        preds["world_points"], preds["world_points_conf"] = dpt_head_forward(
            model.point_head, layer_outputs, hcfg, (H, W), "inv_log", "expp1",
            chunk_size=dpt_chunk, compute_dtype=dpt_dtype)
    return preds

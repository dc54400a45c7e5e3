"""VGGT top-level model (``videogpa_tpu/models/vggt/model.py``).

The aggregator trunk runs in ``compute_dtype`` (bf16 on the card); the camera
head in float32; the depth and point DPT heads in ``dpt_dtype``. Only the
DPT taps and the final layer of the trunk are kept. With ``enable_track``
the model holds the track head (``track.py``), which runs in float32 when
``vggt_forward`` is given ``query_points``.
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
from videogpa_torch.models.vggt.track import TrackHead, random_init_, track_head_forward
from videogpa_torch.ops import layers as L
from videogpa_torch.ops.transformer import LayerScale


class VGGT(nn.Module):
    """The model's parameters, named as the JAX tree of ``vggt_init``;
    ``forward`` is :func:`vggt_forward`."""

    def __init__(self, cfg: VGGTConfig, device=None, dtype=None, enable_track: bool = False):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.cfg = cfg
        self.aggregator = Aggregator(cfg, **fk)
        self.camera_head = CameraHead(cfg, **fk) if cfg.enable_camera else None
        self.depth_head = DPTHead(cfg, output_dim=2, **fk) if cfg.enable_depth else None
        self.point_head = DPTHead(cfg, output_dim=4, **fk) if cfg.enable_point else None
        self.track_head = TrackHead(cfg, **fk) if enable_track else None

    def forward(self, images: torch.Tensor, **kwargs) -> Dict[str, torch.Tensor]:
        return vggt_forward(self, images, **kwargs)


@torch.no_grad()
def vggt_init(cfg: VGGTConfig, generator: Optional[torch.Generator] = None, device=None,
              dtype: torch.dtype = torch.float32, enable_track: bool = False) -> VGGT:
    """Random VGGT allocated straight on ``device`` in ``dtype``, drawn as
    the JAX initialisers draw (different numbers): kaiming-uniform linears
    and convs, layer norms ones/zeros, LayerScale at its init value, the
    aggregator's camera/register tokens N(0, 1e-6), DINOv2's pos-embed
    N(0, 0.02), its cls/register tokens and the empty pose token zero; with
    ``enable_track`` the track head last (its query tokens and virtual
    tracks N(0, 1)), so the other parts draw as without it.
    ``generator`` must live on ``device``; the default is seeded with 0."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    model = VGGT(cfg, device="meta", dtype=dtype, enable_track=enable_track).to_empty(
        device=device)
    track_head, model.track_head = model.track_head, None
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
    if track_head is not None:
        model.track_head = random_init_(track_head, generator)
    return model


def vggt_forward(model: VGGT, images: torch.Tensor, compute_dtype: torch.dtype = torch.bfloat16,
                 dpt_chunk: int = 8, dpt_dtype: torch.dtype = torch.float32,
                 attn_impl: str = "auto", query_points: Optional[torch.Tensor] = None,
                 track_kwargs: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """images (B, S, 3, H, W) or (S, 3, H, W) in [0, 1] -> dict with pose_enc
    (B, S, 9), pose_enc_list, depth (B, S, H, W, 1), depth_conf (B, S, H, W),
    world_points (B, S, H, W, 3), world_points_conf (B, S, H, W), images;
    with a track head and ``query_points`` ((B, N, 2) or (N, 2) xy pixels)
    also track (B, S, N, 2), vis and conf (B, S, N). ``track_kwargs`` go to
    ``track_head_forward`` (iters, corr_levels, corr_radius)."""
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
    if model.track_head is not None and query_points is not None:
        if query_points.dim() == 2:
            query_points = query_points[None]
        track_list, vis, conf = track_head_forward(
            model.track_head, layer_outputs, (H, W), query_points, hcfg, **(track_kwargs or {}))
        preds["track"], preds["vis"], preds["conf"] = track_list[-1], vis, conf
    return preds

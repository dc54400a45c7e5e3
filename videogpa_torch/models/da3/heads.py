"""DA3's heads (``videogpa_tpu/models/da3/heads.py``): DualDPT (depth + ray),
CameraDec and CameraEnc.

DualDPT runs two independent fusion chains over one projection pyramid:
main (depth and its confidence, exp and 1 + exp) and aux (6 ray channels and
a confidence, with a LayerNorm in its output head). It reuses VGGT's DPT
pieces with the raw-x residual of DA3's fusion blocks (``inplace_relu=False``).
The heads run in f32: each pyramid level casts its own slice of the trunk's
tokens, so no f32 copy of the whole token stack is made; the convolutions take
``ops/layers.py``'s f32 path (cuDNN's TF32 off). DA3 has no frame chunking in
its DPT: at 40 frames x 518^2 the full-resolution f32 maps take about 5.5 GB.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn

from videogpa_torch.geometry.pose_enc import extri_intri_to_pose_encoding
from videogpa_torch.geometry.transforms import affine_inverse
from videogpa_torch.models.da3.config import DA3Config
from videogpa_torch.models.da3.vit import _drawn
from videogpa_torch.models.vggt.heads import _fusion, _fusion_block, uv_pos_embed
from videogpa_torch.ops import layers as L
from videogpa_torch.ops.resize import resize_bilinear
from videogpa_torch.ops.transformer import Block, BlockConfig, block_apply

# the aux chain's output_conv1 channel sequences, by ``aux_out1_conv_num``
_AUX_CHANNELS = {5: lambda f: [(f, f // 2), (f // 2, f), (f, f // 2), (f // 2, f), (f, f // 2)],
                 3: lambda f: [(f, f // 2), (f // 2, f), (f, f // 2)],
                 1: lambda f: [(f, f // 2)]}


class DualDPT(nn.Module):
    """The head's parameters, named as the JAX tree of ``dualdpt_init``."""

    def __init__(self, cfg: DA3Config, device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.cfg = cfg
        oc, f, dim_in = cfg.dpt_out_channels, cfg.dpt_features, cfg.tokens_dim
        self.norm = L.LayerNorm(dim_in, **fk)
        self.projects = nn.ModuleList(L.Conv2d(dim_in, c, 1, **fk) for c in oc)
        self.resize0 = L.ConvTranspose2d(oc[0], oc[0], 4, stride=4, **fk)
        self.resize1 = L.ConvTranspose2d(oc[1], oc[1], 2, stride=2, **fk)
        self.resize3 = L.Conv2d(oc[3], oc[3], 3, stride=2, padding=1, **fk)
        self.layer_rn = nn.ModuleList(L.Conv2d(c, f, 3, padding=1, bias=False, **fk)
                                      for c in oc)
        for n in (1, 2, 3, 4):
            self.add_module(f"refinenet{n}", _fusion_block(f, n != 4, **fk))
        for n in (1, 2, 3, 4):
            self.add_module(f"refinenet{n}_aux", _fusion_block(f, n != 4, **fk))
        self.output_conv1 = L.Conv2d(f, f // 2, 3, padding=1, **fk)
        self.output_conv2a = L.Conv2d(f // 2, 32, 3, padding=1, **fk)
        self.output_conv2b = L.Conv2d(32, 2, 1, **fk)
        # one conv chain per pyramid level, as the checkpoint holds them; the
        # forward runs the last level's
        self.output_conv1_aux = nn.ModuleList(
            nn.ModuleList(L.Conv2d(a, b, 3, padding=1, **fk)
                          for a, b in _AUX_CHANNELS[cfg.aux_out1_conv_num](f))
            for _ in range(4))
        self.output_conv2a_aux = L.Conv2d(f // 2, 32, 3, padding=1, **fk)
        self.output_conv2_ln_aux = L.LayerNorm(32, **fk)
        self.output_conv2b_aux = L.Conv2d(32, 7, 1, **fk)


def dualdpt_init(cfg: DA3Config, generator: Optional[torch.Generator] = None, device=None,
                 dtype: torch.dtype = torch.float32) -> DualDPT:
    """A random DualDPT on ``device`` in ``dtype`` (``vit._drawn``)."""
    model = _drawn(lambda **fk: DualDPT(cfg, **fk), generator, device)[0]
    return model.to(dtype).requires_grad_(False)


def dualdpt_forward(head: DualDPT, feats: List[Tuple[torch.Tensor, torch.Tensor]],
                    img_hw) -> Dict[str, torch.Tensor]:
    """feats: the 4 (tokens (B, S, P, 2C), camera token) pairs of the trunk.
    Returns f32 depth (B, S, H, W), depth_conf, ray (B, S, h, w, 6) and
    ray_conf (B, S, h, w), (h, w) the aux chain's resolution."""
    cfg = head.cfg
    H, W = img_hw
    ph, pw = H // cfg.patch_size, W // cfg.patch_size
    B, S, P, C2 = feats[0][0].shape

    pyramid = []
    for i in range(4):
        x = head.norm(feats[i][0].reshape(B * S, P, C2).float())
        x = x.transpose(1, 2).reshape(B * S, C2, ph, pw)
        x = head.projects[i](x)
        x = x + uv_pos_embed(ph, pw, x.shape[1], W, H, x.device)
        if i == 0:
            x = head.resize0(x)
        elif i == 1:
            x = head.resize1(x)
        elif i == 3:
            x = head.resize3(x)
        pyramid.append(x)
    l1, l2, l3, l4 = (head.layer_rn[i](p) for i, p in enumerate(pyramid))

    def fuse(name, *xs, size=None):
        return _fusion(getattr(head, name), *xs, size=size, inplace_relu=False)

    out = fuse("refinenet4", l4, size=l3.shape[-2:])
    aux = fuse("refinenet4_aux", l4, size=l3.shape[-2:])
    out = fuse("refinenet3", out, l3, size=l2.shape[-2:])
    aux = fuse("refinenet3_aux", aux, l3, size=l2.shape[-2:])
    out = fuse("refinenet2", out, l2, size=l1.shape[-2:])
    aux = fuse("refinenet2_aux", aux, l2, size=l1.shape[-2:])
    out = fuse("refinenet1", out, l1)
    aux = fuse("refinenet1_aux", aux, l1)

    out = head.output_conv1(out)
    for conv in head.output_conv1_aux[-1]:
        aux = conv(aux)

    out = resize_bilinear(out, (ph * cfg.patch_size, pw * cfg.patch_size), align_corners=True)
    out = out + uv_pos_embed(out.shape[-2], out.shape[-1], out.shape[1], W, H, out.device)
    fmap = head.output_conv2b(torch.relu(head.output_conv2a(out))).permute(0, 2, 3, 1)
    depth = torch.exp(fmap[..., 0])
    depth_conf = 1 + torch.exp(fmap[..., 1])

    aux = aux + uv_pos_embed(aux.shape[-2], aux.shape[-1], aux.shape[1], W, H, aux.device)
    a = head.output_conv2_ln_aux(head.output_conv2a_aux(aux).permute(0, 2, 3, 1))
    fa = head.output_conv2b_aux(torch.relu(a.permute(0, 3, 1, 2))).permute(0, 2, 3, 1)
    ray_conf = 1 + torch.exp(fa[..., 6])

    def rs(t):
        return t.reshape(B, S, *t.shape[1:])

    return {"depth": rs(depth), "depth_conf": rs(depth_conf), "ray": rs(fa[..., :6]),
            "ray_conf": rs(ray_conf)}


def _cam_enc_block_cfg(dim: int) -> BlockConfig:
    return BlockConfig(dim=dim, num_heads=16, mlp_ratio=4.0, init_values=0.01)


class CameraEnc(nn.Module):
    """GT pose encoding -> MLP -> 4 blocks -> camera tokens (reference
    ``model/cam_enc.py:23-80``); parameters named as ``camera_enc_init``'s."""

    def __init__(self, dim_out: int = 1024, device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.pose_branch = L.group(fc1=L.Linear(9, dim_out // 2, **fk),
                                   fc2=L.Linear(dim_out // 2, dim_out, **fk))
        self.token_norm = L.LayerNorm(dim_out, **fk)
        self.trunk = nn.ModuleList(Block(_cam_enc_block_cfg(dim_out), **fk) for _ in range(4))
        self.trunk_norm = L.LayerNorm(dim_out, **fk)


def camera_enc_init(dim_out: int = 1024, generator: Optional[torch.Generator] = None,
                    device=None, dtype: torch.dtype = torch.float32) -> CameraEnc:
    """A random CameraEnc on ``device`` in ``dtype`` (``vit._drawn``)."""
    model = _drawn(lambda **fk: CameraEnc(dim_out, **fk), generator, device)[0]
    return model.to(dtype).requires_grad_(False)


def camera_enc_forward(enc: CameraEnc, ext: torch.Tensor, ixt: torch.Tensor, image_hw,
                       attn_impl: str = "auto") -> torch.Tensor:
    """ext (B, S, 3 or 4, 4) world->camera, ixt (B, S, 3, 3) -> (B, S, dim)
    camera tokens, f32."""
    if ext.shape[-2] == 3:
        bottom = torch.tensor([0.0, 0, 0, 1], dtype=ext.dtype, device=ext.device)
        ext = torch.cat([ext, bottom.expand(ext.shape[:-2] + (1, 4))], dim=-2)
    c2w = affine_inverse(ext)[..., :3, :]
    tok = L.mlp(enc.pose_branch, extri_intri_to_pose_encoding(c2w, ixt, image_hw))
    tok = enc.token_norm(tok)
    for blk in enc.trunk:
        tok = block_apply(blk, tok, attn_impl=attn_impl)
    return enc.trunk_norm(tok)


class CameraDec(nn.Module):
    """Camera tokens -> (t, quat, fov) (reference ``model/cam_dec.py``);
    parameters named as ``camera_dec_init``'s."""

    def __init__(self, dim_in: int, device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.backbone1 = L.Linear(dim_in, dim_in, **fk)
        self.backbone2 = L.Linear(dim_in, dim_in, **fk)
        self.fc_t = L.Linear(dim_in, 3, **fk)
        self.fc_qvec = L.Linear(dim_in, 4, **fk)
        self.fc_fov = L.Linear(dim_in, 2, **fk)


def camera_dec_init(dim_in: int, generator: Optional[torch.Generator] = None, device=None,
                    dtype: torch.dtype = torch.float32) -> CameraDec:
    """A random CameraDec on ``device`` in ``dtype`` (``vit._drawn``)."""
    model = _drawn(lambda **fk: CameraDec(dim_in, **fk), generator, device)[0]
    return model.to(dtype).requires_grad_(False)


def camera_dec_forward(dec: CameraDec, feat: torch.Tensor) -> torch.Tensor:
    """feat (B, S, 2C) camera tokens in the trunk's dtype -> (B, S, 9) f32
    pose encoding (camera->world); the MLP's hidden layers run in the
    trunk's dtype, its outputs in f32, as in the JAX package."""
    h = torch.relu(dec.backbone2(torch.relu(dec.backbone1(feat)))).float()
    return torch.cat([dec.fc_t(h), dec.fc_qvec(h), torch.relu(dec.fc_fov(h))], dim=-1)

"""DA3's top-level net and inference API (``videogpa_tpu/models/da3/model.py``).

AA-ViT in the compute dtype -> DualDPT in f32 -> CameraDec -> pose decode;
extrinsics are world->camera. With GT cameras, CameraEnc's tokens replace
the learned camera token. ``da3_inference`` takes uint8 frames, normalises
them and returns numpy outputs, aligned to GT extrinsics when given.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from videogpa_torch.geometry.pose_enc import pose_encoding_to_extri_intri
from videogpa_torch.geometry.transforms import affine_inverse
from videogpa_torch.models.da3.config import DA3Config
from videogpa_torch.models.da3.heads import (
    CameraDec, CameraEnc, DualDPT, camera_dec_forward, camera_enc_forward, dualdpt_forward)
from videogpa_torch.models.da3.vit import AAViT, _draw_tokens_, _drawn, aavit_forward

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


class DA3(nn.Module):
    """The model's parameters, named as the JAX tree of ``da3_init``;
    ``forward`` is :func:`da3_forward`. ``cam_enc=False`` leaves out the
    camera encoder, as a checkpoint without one (``convert_da3``'s rule)."""

    def __init__(self, cfg: DA3Config, cam_enc: bool = True, device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.cfg = cfg
        self.backbone = AAViT(cfg, **fk)
        self.head = DualDPT(cfg, **fk)
        self.cam_dec = CameraDec(cfg.tokens_dim, **fk)
        self.cam_enc = CameraEnc(cfg.embed_dim, **fk) if cam_enc else None

    def forward(self, images: torch.Tensor, **kwargs) -> Dict[str, torch.Tensor]:
        return da3_forward(self, images, **kwargs)


@torch.no_grad()
def da3_init(cfg: DA3Config, generator: Optional[torch.Generator] = None, device=None,
             dtype: torch.dtype = torch.float32) -> DA3:
    """Random DA3 on ``device``, drawn as ``aavit_init`` and the heads'
    initialisers draw (``vit._drawn``, then the backbone's tokens). The
    backbone is in ``dtype``; the heads and the camera encoder and decoder
    stay f32, as the scorer runs them. ``generator`` lives on ``device``
    (default: seeded with 0)."""
    model, generator = _drawn(lambda **fk: DA3(cfg, **fk), generator, device)
    _draw_tokens_(model.backbone, generator)
    model.backbone.to(dtype)
    return model.requires_grad_(False)


def da3_forward(model: DA3, images: torch.Tensor, attn_impl: str = "auto",
                compute_dtype: torch.dtype = torch.float32,
                gt_extrinsics: Optional[torch.Tensor] = None,
                gt_intrinsics: Optional[torch.Tensor] = None,
                return_features: bool = False) -> Dict[str, torch.Tensor]:
    """images (B, S, 3, H, W), ImageNet-normalised. Returns depth (B, S, H, W),
    depth_conf, ray, ray_conf, extrinsics (B, S, 3, 4) world->camera,
    intrinsics (B, S, 3, 3), pose_enc (B, S, 9), and with ``return_features``
    the last out layer's patch tokens (B, S, P, 2C) in f32."""
    B, S, _, H, W = images.shape
    cam_token = None
    if gt_extrinsics is not None and model.cam_enc is not None:
        cam_token = camera_enc_forward(model.cam_enc, gt_extrinsics, gt_intrinsics, (H, W),
                                       attn_impl).to(compute_dtype)
    feats = aavit_forward(model.backbone, images.to(compute_dtype), cam_token=cam_token,
                          attn_impl=attn_impl)
    out = dualdpt_forward(model.head, feats, (H, W))
    pose_enc = camera_dec_forward(model.cam_dec, feats[-1][1])
    c2w, intr = pose_encoding_to_extri_intri(pose_enc, (H, W))
    out["extrinsics"] = affine_inverse(c2w)
    out["intrinsics"] = intr
    out["pose_enc"] = pose_enc
    if return_features:
        out["features"] = feats[-1][0].float()
    return out


@dataclasses.dataclass
class DA3Prediction:
    """Numpy prediction (reference ``depth_anything_3/specs.py:36-47``)."""

    depth: np.ndarray  # (S, H, W)
    conf: Optional[np.ndarray]  # (S, H, W)
    extrinsics: np.ndarray  # (S, 3, 4) world->camera
    intrinsics: np.ndarray  # (S, 3, 3)
    processed_images: np.ndarray  # (S, H, W, 3) uint8-scale
    gaussians: Optional[object] = None  # models.da3.gaussians.Gaussians
    features: Optional[np.ndarray] = None  # (S, H/14, W/14, C), for feat_vis


def _normalised_upload(frames: np.ndarray, device):
    """(S, H, W, 3) uint8 -> (frames / 255 as f32, (1, S, 3, H, W)
    ImageNet-normalised f32 on ``device``), normalised on the host as the
    JAX package does."""
    imgs = frames.astype(np.float32) / 255.0
    normed = (imgs - np.asarray(IMAGENET_MEAN, np.float32)) / np.asarray(IMAGENET_STD,
                                                                          np.float32)
    return imgs, torch.from_numpy(normed.transpose(0, 3, 1, 2)[None].copy()).to(device)


@torch.no_grad()
def da3_inference(model: DA3, frames: np.ndarray, attn_impl: str = "auto",
                  compute_dtype: torch.dtype = torch.bfloat16,
                  gt_extrinsics: Optional[np.ndarray] = None,
                  return_features: bool = False) -> DA3Prediction:
    """frames (S, H, W, 3) uint8 RGB (sides divisible by 14) on the model's
    device. With gt_extrinsics (S, 3 or 4, 4) the predicted trajectory is
    aligned to them by Umeyama Sim(3), RANSAC at >= 10 views, and the depth
    scaled with it (reference ``api.py:341-365``)."""
    imgs, x = _normalised_upload(frames, next(model.parameters()).device)
    out = da3_forward(model, x, attn_impl, compute_dtype, return_features=return_features)
    extr = out["extrinsics"][0].float().cpu().numpy()
    depth = out["depth"][0].float().cpu().numpy()
    if gt_extrinsics is not None:
        from videogpa_torch.geometry.alignment import align_poses_umeyama

        _, _, scale, aligned = align_poses_umeyama(gt_extrinsics, extr, return_aligned=True,
                                                   ransac=len(extr) >= 10, random_state=0)
        extr = aligned[:, :3].astype(np.float32)
        depth = depth * scale
    features = None
    if return_features:
        S, H, W = depth.shape
        feats = out["features"][0].cpu().numpy()
        features = feats.reshape(S, H // 14, W // 14, feats.shape[-1])
    return DA3Prediction(depth=depth, conf=out["depth_conf"][0].float().cpu().numpy(),
                         extrinsics=extr, intrinsics=out["intrinsics"][0].float().cpu().numpy(),
                         processed_images=(imgs * 255.0).astype(np.float32), features=features)

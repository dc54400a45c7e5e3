"""SuperPoint keypoint detector and descriptor
(``videogpa_tpu/models/matching/superpoint.py``).

MagicLeap's SuperPoint as the reference's LightGlue matcher runs it: a shared
VGG-style encoder, a 65-channel detector head (8 x 8 cells and a dustbin,
softmax, depth-to-space) and a 256-d descriptor head, L2-normalised.
Keypoint selection (NMS, top-k) keeps static shapes, as the JAX package's
does. Every f32 convolution goes through ``ops.layers`` (TF32 off on the
card): keypoint selection is discontinuous, and TF32 would move keypoints.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from videogpa_torch.device import resolve_device
from videogpa_torch.ops import layers as L
from videogpa_torch.ops.resize import grid_sample_bilinear

_CONVS = ("conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b",
          "conv4a", "conv4b", "convPa", "convPb", "convDa", "convDb")


@dataclasses.dataclass(frozen=True)
class SuperPointConfig:
    descriptor_dim: int = 256
    channels: Tuple[int, ...] = (64, 64, 64, 64, 128, 128, 128, 128)
    nms_radius: int = 4
    max_num_keypoints: int = 2048
    detection_threshold: float = 0.0005


class SuperPoint(nn.Module):
    """The convolutions of ``superpoint_init``'s tree, named as the magicleap
    checkpoint names them."""

    def __init__(self, cfg: SuperPointConfig = SuperPointConfig(), device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        in_ch = 1
        for i, out_ch in enumerate(cfg.channels):
            setattr(self, _CONVS[i], L.Conv2d(in_ch, out_ch, 3, padding=1, **fk))
            in_ch = out_ch
        self.convPa = L.Conv2d(in_ch, 256, 3, padding=1, **fk)
        self.convPb = L.Conv2d(256, 65, 1, **fk)
        self.convDa = L.Conv2d(in_ch, 256, 3, padding=1, **fk)
        self.convDb = L.Conv2d(256, cfg.descriptor_dim, 1, **fk)


def superpoint_config_of(tree: Mapping, cfg: SuperPointConfig = SuperPointConfig()
                         ) -> SuperPointConfig:
    """``cfg`` with the widths of a ``superpoint_init``-shaped tree."""
    return dataclasses.replace(
        cfg, channels=tuple(int(np.shape(tree[n]["kernel"])[-1]) for n in _CONVS[:8]),
        descriptor_dim=int(np.shape(tree["convDb"]["kernel"])[-1]))


@torch.no_grad()
def superpoint_init(cfg: SuperPointConfig = SuperPointConfig(),
                    generator: Optional[torch.Generator] = None, device=None,
                    dtype: torch.dtype = torch.float32) -> SuperPoint:
    """A random SuperPoint on ``device``, kaiming-uniform as the JAX
    initialiser draws (different numbers). ``generator`` lives on ``device``
    (default: seeded with 0)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    model = SuperPoint(cfg, device="meta", dtype=dtype).to_empty(device=device)
    L.kaiming_uniform_init_(model, generator)
    return model.requires_grad_(False)


def superpoint_forward(model: SuperPoint, image: torch.Tensor,
                       cfg: SuperPointConfig = SuperPointConfig()):
    """image (B, 1, H, W) in [0, 1], H and W divisible by 8. Returns
    (scores (B, H, W), descriptors (B, D, H/8, W/8))."""
    x = image
    for i, name in enumerate(_CONVS[:8]):
        x = torch.relu(getattr(model, name)(x))
        if i in (1, 3, 5):
            x = F.max_pool2d(x, 2, 2)

    # detector: 65-channel softmax, dustbin dropped, depth-to-space 8x
    sc = model.convPb(torch.relu(model.convPa(x)))
    sc = torch.softmax(sc, dim=1)[:, :64]
    B, _, Hc, Wc = sc.shape
    sc = sc.reshape(B, 8, 8, Hc, Wc).permute(0, 3, 1, 4, 2).reshape(B, Hc * 8, Wc * 8)

    de = model.convDb(torch.relu(model.convDa(x)))
    de = de / torch.clamp(torch.linalg.vector_norm(de, dim=1, keepdim=True), min=1e-8)
    return sc, de


def _nms(scores: torch.Tensor, radius: int) -> torch.Tensor:
    """Keep only the local maxima of each (2r+1)^2 window (-inf padding)."""
    pooled = F.max_pool2d(scores[:, None], 2 * radius + 1, stride=1, padding=radius)[:, 0]
    return torch.where(scores == pooled, scores, 0.0)


def _top_k(s: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest, descending, equal
    values lowest index first (``torch.topk`` promises no order among equal
    values). Selects on int64 keys, unique a row: the f32 bits made monotone
    as a signed int32, above the reversed index."""
    bits = s.contiguous().view(torch.int32)
    order = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long()
    n = s.shape[-1]
    keys = (order << 32) | torch.arange(n - 1, -1, -1, device=s.device)
    idx = torch.topk(keys, k, dim=-1).indices
    return s.gather(-1, idx), idx


def extract_keypoints(scores: torch.Tensor, descriptors: torch.Tensor,
                      cfg: SuperPointConfig = SuperPointConfig()):
    """scores (B, H, W), descriptors (B, D, H/8, W/8) -> (kpts (B, K, 2) xy
    pixels, kp_scores (B, K), desc (B, K, D), valid (B, K) bool) with K =
    ``cfg.max_num_keypoints``."""
    B, H, W = scores.shape
    s = _nms(scores, cfg.nms_radius).reshape(B, -1)
    top, idx = _top_k(s, cfg.max_num_keypoints)
    kpts = torch.stack([idx % W, idx // W], dim=-1).float()
    valid = top > cfg.detection_threshold

    # bilinear samples of every channel at once on the H/8 descriptor grid
    u = (kpts[..., 0] - 3.5) / 8.0
    v = (kpts[..., 1] - 3.5) / 8.0
    desc = torch.stack([grid_sample_bilinear(descriptors[b].permute(1, 2, 0), u[b], v[b])
                        for b in range(B)])
    desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-8)
    return kpts, top, desc, valid


def convert_superpoint(sd: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """``SuperPoint`` state dict from the magicleap superpoint_v1 checkpoint
    (``videogpa_tpu/models/matching/superpoint.py::convert_superpoint``):
    the same torch conv layout under the same names."""
    return {f"{n}.{p}": np.asarray(sd[f"{n}.{p}"]) for n in _CONVS for p in ("weight", "bias")}

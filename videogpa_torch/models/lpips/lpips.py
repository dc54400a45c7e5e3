"""LPIPS, VGG16 variant (``videogpa_tpu/models/lpips/lpips.py``).

input in [-1, 1] -> per-channel shift/scale -> VGG16 features at relu1_2,
relu2_2, relu3_3, relu4_3, relu5_3 -> channel-unit-normalise, squared
difference -> learned 1x1 "lin" weights, spatial mean, sum over the 5 taps.
The module tree mirrors ``lpips_init``'s (``convs.{i}``, ``lins.{i}``);
``convert_lpips`` maps torchvision's ``vgg16.features`` and the lpips
package's ``lin*`` checkpoints onto it. Float32 convolutions stay in full f32
on the card (``ops.layers.conv2d``).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import numpy as np

import torch
import torch.nn as nn
import torch.nn.functional as F

from videogpa_torch.device import resolve_device
from videogpa_torch.ops import layers as L

_VGG16_CONVS = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)  # torchvision indices
_VGG16_CHANNELS = [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]
_TAP_AFTER_CONV = (1, 3, 6, 9, 12)  # relu taps, as positions in the conv list
_POOL_AFTER_CONV = (1, 3, 6, 9)  # 2x2 max-pool after these convs
_TAP_CHANNELS = (64, 128, 256, 512, 512)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class LPIPS(nn.Module):
    def __init__(self, device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        convs, in_ch = [], 3
        for out_ch in _VGG16_CHANNELS:
            convs.append(L.Conv2d(in_ch, out_ch, 3, padding=1, **fk))
            in_ch = out_ch
        self.convs = nn.ModuleList(convs)
        self.lins = nn.ModuleList(L.Conv2d(c, 1, 1, bias=False, **fk) for c in _TAP_CHANNELS)


@torch.no_grad()
def lpips_init(generator: Optional[torch.Generator] = None, device=None,
               dtype: torch.dtype = torch.float32) -> LPIPS:
    """Random LPIPS (structure only; real weights come through
    ``convert_lpips``), kaiming-uniform as the JAX initialiser draws."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    model = LPIPS(device="meta", dtype=dtype).to_empty(device=device)
    L.kaiming_uniform_init_(model, generator)
    return model


def _vgg_features(model: LPIPS, x: torch.Tensor) -> List[torch.Tensor]:
    feats = []
    h = x
    for i, conv in enumerate(model.convs):
        h = torch.relu(conv(h))
        if i in _TAP_AFTER_CONV:
            feats.append(h)
        if i in _POOL_AFTER_CONV:
            # the JAX package's 2x2 min-of-negatives window is this max-pool
            h = F.max_pool2d(h, 2, 2)
    return feats


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (torch.sqrt((x * x).sum(dim=1, keepdim=True)) + eps)


def lpips_distance(model: LPIPS, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-sample distance of x, y (B, 3, H, W) in [-1, 1] -> (B,)."""
    shift = torch.tensor(_SHIFT, dtype=x.dtype, device=x.device).reshape(1, 3, 1, 1)
    scale = torch.tensor(_SCALE, dtype=x.dtype, device=x.device).reshape(1, 3, 1, 1)
    fx = _vgg_features(model, (x - shift) / scale)
    fy = _vgg_features(model, (y - shift) / scale)
    total = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
    for lin, a, b in zip(model.lins, fx, fy):
        d = (_unit_normalize(a) - _unit_normalize(b)) ** 2
        total = total + lin(d).mean(dim=(1, 2, 3))
    return total


def convert_lpips(vgg_sd: Mapping[str, np.ndarray],
                  lin_sd: Mapping[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """``LPIPS`` state dict from torchvision vgg16 ``features.*`` and the lpips
    package's ``lin{i}.model.1.weight`` (or ``lins.{i}.model.1.weight``)
    (``videogpa_tpu/models/lpips/lpips.py::convert_lpips``)."""
    out: Dict[str, np.ndarray] = {}
    for i, idx in enumerate(_VGG16_CONVS):
        out[f"convs.{i}.weight"] = np.asarray(vgg_sd[f"features.{idx}.weight"])
        out[f"convs.{i}.bias"] = np.asarray(vgg_sd[f"features.{idx}.bias"])
    for i in range(len(_TAP_CHANNELS)):
        key = f"lin{i}.model.1.weight"
        if key not in lin_sd:
            key = f"lins.{i}.model.1.weight"
        out[f"lins.{i}.weight"] = np.asarray(lin_sd[key])  # (1, C, 1, 1)
    return out

"""facebook/VGGT-1B checkpoints <-> the port's ``VGGT`` state dicts
(``videogpa_tpu/models/vggt/convert.py``).

The upstream module tree (``vggt/models/vggt.py``, ``aggregator.py``,
``heads/*``) holds its tensors in torch layouts already, so conversion renames
keys. The port's ``VGGT`` names its modules as the JAX tree does; it differs
from the upstream names in these places only: DINOv2's patch projection
(``patch_embed.proj``), the camera head's ``poseLN_modulation`` (a
Sequential(SiLU, Linear): index 1), and the DPT heads' ``resize_layers``,
``scratch.layer{n}_rn``, ``scratch.refinenet{n}.resConfUnit{m}`` and
``scratch.output_conv*`` (``_upstream_key``). An upstream key that no port
key names is not read (DINOv2's ``mask_token``, the track head), as in the
JAX converter; a head whose marker key is absent is left out, as there.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch.nn as nn

from videogpa_torch.models.vggt.config import VGGTConfig

_DPT = r"^((?:depth|point)_head)\."
_RULES = (
    (re.compile(r"^aggregator\.patch_embed\.patch_embed\."),
     "aggregator.patch_embed.patch_embed.proj."),
    (re.compile(r"^camera_head\.poseLN_modulation\."), "camera_head.poseLN_modulation.1."),
    (re.compile(_DPT + r"resize(\d)\."), r"\1.resize_layers.\2."),
    (re.compile(_DPT + r"layer_rn\.(\d)\."), lambda m: f"{m[1]}.scratch.layer{int(m[2]) + 1}_rn."),
    (re.compile(_DPT + r"refinenet(\d)\.rcu(\d)\."), r"\1.scratch.refinenet\2.resConfUnit\3."),
    (re.compile(_DPT + r"refinenet(\d)\.out_conv\."), r"\1.scratch.refinenet\2.out_conv."),
    (re.compile(_DPT + r"output_conv1\."), r"\1.scratch.output_conv1."),
    (re.compile(_DPT + r"output_conv2a\."), r"\1.scratch.output_conv2.0."),
    (re.compile(_DPT + r"output_conv2b\."), r"\1.scratch.output_conv2.2."),
)
# a head is converted only when the checkpoint holds it (JAX converter's rule)
_HEAD_MARKERS = {"camera_head": "camera_head.token_norm.weight",
                 "depth_head": "depth_head.norm.weight",
                 "point_head": "point_head.norm.weight"}


def _upstream_key(key: str) -> str:
    for pattern, repl in _RULES:
        new, n = pattern.subn(repl, key, count=1)
        if n:
            return new
    return key


# one DINOv2 block's keys, the same in the upstream checkpoint and the port
_DINOV2_BLOCK = tuple(f"{m}.{leaf}" for m in ("norm1", "attn.qkv", "attn.proj", "norm2",
                                              "mlp.fc1", "mlp.fc2")
                      for leaf in ("weight", "bias")) + ("ls1.gamma", "ls2.gamma")


def convert_dinov2(sd: Mapping[str, np.ndarray], pfx: str, depth: int) -> Dict[str, np.ndarray]:
    """The DINOv2 ViT under ``pfx`` of an upstream state dict (``depth``
    blocks) -> ``DinoV2``'s state dict (numpy arrays)."""
    out = {"patch_embed.weight": sd[f"{pfx}.patch_embed.proj.weight"],
           "patch_embed.bias": sd[f"{pfx}.patch_embed.proj.bias"]}
    for name in ("cls_token", "register_tokens", "pos_embed", "norm.weight", "norm.bias"):
        out[name] = sd[f"{pfx}.{name}"]
    for i in range(depth):
        for name in _DINOV2_BLOCK:
            out[f"blocks.{i}.{name}"] = sd[f"{pfx}.blocks.{i}.{name}"]
    return {k: np.asarray(v) for k, v in out.items()}


def _port_keys(cfg: VGGTConfig):
    from videogpa_torch.models.vggt.model import VGGT

    return list(VGGT(cfg, device="meta").state_dict())


def convert_vggt(sd: Mapping[str, np.ndarray], cfg: VGGTConfig) -> Dict[str, np.ndarray]:
    """Upstream VGGT state dict -> ``VGGT(cfg)`` state dict (numpy arrays).
    Raises ``KeyError`` naming the first upstream key a present part lacks."""
    out: Dict[str, np.ndarray] = {}
    for key in _port_keys(cfg):
        head = key.split(".", 1)[0]
        if head in _HEAD_MARKERS and _HEAD_MARKERS[head] not in sd:
            continue
        out[key] = np.asarray(sd[_upstream_key(key)])
    return out


def export_vggt(model: nn.Module) -> Dict[str, np.ndarray]:
    """Inverse of ``convert_vggt``: a ``VGGT`` -> f32 numpy arrays under the
    upstream checkpoint's keys (a checkpoint in the facebook/VGGT-1B layout)."""
    return {_upstream_key(k): v.detach().float().cpu().numpy()
            for k, v in model.state_dict().items()}

"""diffusers CogVideoX checkpoints <-> the port's module state dicts
(``videogpa_tpu/models/cogvideox/convert.py``).

Key layout of diffusers' ``CogVideoXTransformer3DModel`` and
``AutoencoderKLCogVideoX``. Their tensors are already in torch layouts, so
conversion renames keys: ``convert_dit`` / ``convert_vae`` map a checkpoint
state dict onto ``CogVideoXTransformer`` / ``CogVideoXVAE`` keys, and
``export_dit`` maps a DiT back to diffusers keys (PEFT / HF interop). A
checkpoint key that no rule names is not read, as in the JAX converters; a
module key with no checkpoint tensor raises at the strict load.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch.nn as nn

from videogpa_torch.models.cogvideox.config import CogVideoXConfig

# (port module prefix, diffusers module prefix); each carries .weight and
# optionally .bias
Pairs = List[Tuple[str, str]]

_BLOCK = [
    ("norm1.linear", "norm1.linear"), ("norm1.norm", "norm1.norm"),
    ("attn1.to_q", "attn1.to_q"), ("attn1.to_k", "attn1.to_k"),
    ("attn1.to_v", "attn1.to_v"), ("attn1.to_out", "attn1.to_out.0"),
    ("attn1.norm_q", "attn1.norm_q"), ("attn1.norm_k", "attn1.norm_k"),
    ("norm2.linear", "norm2.linear"), ("norm2.norm", "norm2.norm"),
    ("ff.fc1", "ff.net.0.proj"), ("ff.fc2", "ff.net.2"),
]


def _dit_pairs(cfg: CogVideoXConfig, with_ofs: bool) -> Pairs:
    pairs = [("patch_embed.proj", "patch_embed.proj"),
             ("patch_embed.text_proj", "patch_embed.text_proj"),
             ("time_embedding.linear_1", "time_embedding.linear_1"),
             ("time_embedding.linear_2", "time_embedding.linear_2")]
    for i in range(cfg.num_layers):
        pairs += [(f"blocks.{i}.{a}", f"transformer_blocks.{i}.{b}") for a, b in _BLOCK]
    pairs += [("norm_final", "norm_final"), ("norm_out.linear", "norm_out.linear"),
              ("norm_out.norm", "norm_out.norm"), ("proj_out", "proj_out")]
    if with_ofs:
        pairs += [("ofs_embedding.linear_1", "ofs_embedding.linear_1"),
                  ("ofs_embedding.linear_2", "ofs_embedding.linear_2")]
    return pairs


def _rename(sd: Mapping[str, np.ndarray], pairs: Pairs, src: int) -> Dict[str, np.ndarray]:
    """Copy ``{prefix}.weight`` / ``.bias`` from side ``src`` of each pair
    (0 the port's, 1 diffusers') to the other side's name."""
    out: Dict[str, np.ndarray] = {}
    for pair in pairs:
        frm, to = pair[src], pair[1 - src]
        for leaf in ("weight", "bias"):
            if f"{frm}.{leaf}" in sd:
                out[f"{to}.{leaf}"] = np.asarray(sd[f"{frm}.{leaf}"])
    return out


def convert_dit(sd: Mapping[str, np.ndarray], cfg: CogVideoXConfig) -> Dict[str, np.ndarray]:
    """diffusers transformer state dict -> ``CogVideoXTransformer`` state dict."""
    out = _rename(sd, _dit_pairs(cfg, "ofs_embedding.linear_1.weight" in sd), src=1)
    if "patch_embed.pos_embedding" in sd:
        out["pos_embedding"] = np.asarray(sd["patch_embed.pos_embedding"])
    return out


def export_dit(model: nn.Module, cfg: CogVideoXConfig) -> Dict[str, np.ndarray]:
    """Inverse of ``convert_dit``: a DiT (its state dict) -> diffusers keys."""
    sd = {k: v.detach().float().cpu().numpy() for k, v in model.state_dict().items()}
    out = _rename(sd, _dit_pairs(cfg, "ofs_embedding.linear_1.weight" in sd), src=0)
    if "pos_embedding" in sd:
        out["patch_embed.pos_embedding"] = sd["pos_embedding"]
    return out


def _vae_resnet(ours: str, theirs: str, spatial: bool, shortcut: bool) -> Pairs:
    pairs = [(f"{ours}.conv1", f"{theirs}.conv1.conv"),
             (f"{ours}.conv2", f"{theirs}.conv2.conv")]
    for n in ("norm1", "norm2"):
        pairs += _spatial_norm(f"{ours}.{n}", f"{theirs}.{n}") if spatial else [
            (f"{ours}.{n}", f"{theirs}.{n}")]
    if shortcut:
        pairs.append((f"{ours}.conv_shortcut", f"{theirs}.conv_shortcut.conv"))
    return pairs


def _spatial_norm(ours: str, theirs: str) -> Pairs:
    return [(f"{ours}.norm", f"{theirs}.norm_layer"), (f"{ours}.conv_y", f"{theirs}.conv_y.conv"),
            (f"{ours}.conv_b", f"{theirs}.conv_b.conv")]


def convert_vae(sd: Mapping[str, np.ndarray], cfg: CogVideoXConfig) -> Dict[str, np.ndarray]:
    """diffusers ``AutoencoderKLCogVideoX`` state dict -> ``CogVideoXVAE`` state dict."""
    ch, npb = cfg.vae_block_out_channels, cfg.vae_layers_per_block

    def resnet(ours, theirs, spatial):
        return _vae_resnet(ours, theirs, spatial, f"{theirs}.conv_shortcut.conv.weight" in sd)

    pairs = [("encoder.conv_in", "encoder.conv_in.conv")]
    for i in range(len(ch)):
        for j in range(npb):
            pairs += resnet(f"encoder.down.{i}.resnets.{j}",
                            f"encoder.down_blocks.{i}.resnets.{j}", False)
        pairs.append((f"encoder.down.{i}.downsample.conv",
                      f"encoder.down_blocks.{i}.downsamplers.0.conv"))
    for j in range(2):
        pairs += resnet(f"encoder.mid.resnets.{j}", f"encoder.mid_block.resnets.{j}", False)
    pairs += [("encoder.norm_out", "encoder.norm_out"),
              ("encoder.conv_out", "encoder.conv_out.conv"),
              ("decoder.conv_in", "decoder.conv_in.conv")]
    for j in range(2):
        pairs += resnet(f"decoder.mid.resnets.{j}", f"decoder.mid_block.resnets.{j}", True)
    for i in range(len(ch)):
        for j in range(npb + 1):
            pairs += resnet(f"decoder.up.{i}.resnets.{j}",
                            f"decoder.up_blocks.{i}.resnets.{j}", True)
        pairs.append((f"decoder.up.{i}.upsample.conv",
                      f"decoder.up_blocks.{i}.upsamplers.0.conv"))
    pairs += _spatial_norm("decoder.norm_out", "decoder.norm_out")
    pairs.append(("decoder.conv_out", "decoder.conv_out.conv"))
    return _rename(sd, pairs, src=1)

"""Wan2.2 checkpoints -> the port's module state dicts
(``videogpa_tpu/models/wan/convert.py``).

Key layout of the Wan repo's module trees, whose tensors are already in
torch layouts, so conversion renames keys (and flattens the VAE's RMS
gammas):

- ``WanModel`` (``convert_wan``): Sequential indices text/time_embedding =
  [Linear, GELU/SiLU, Linear] -> .0/.2, time_projection = [SiLU, Linear] ->
  .1, ffn = [Linear, GELU, Linear] -> .0/.2; ``freqs`` is a derived rope
  buffer and is not read;
- ``WanVAE_`` of ``wan/modules/vae2_2.py`` (``convert_wan_vae``):
  ``encoder.conv1`` / ``encoder.downsamples.{i}.downsamples.{j}`` (the
  resnets, then the Resample) / ``encoder.middle.{0,1,2}`` /
  ``encoder.head.{0,2}`` / root ``conv1`` and ``conv2`` (quant and
  post-quant) / the decoder's mirror under ``upsamples``. The AvgDown3D /
  DupUp3D shortcuts have no keys.

A checkpoint key that no rule names is not read, as in the JAX converters;
a module key with no checkpoint tensor raises at the strict load
(``models.loader._module_from_state_dict``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np

from videogpa_torch.models.wan.config import WanConfig

StateDict = Dict[str, np.ndarray]


def t_linear(sd: Mapping[str, np.ndarray], src: str, dst: str) -> StateDict:
    """A torch Linear (or Conv) under ``src`` as the module under ``dst``:
    its weight and, where the checkpoint has one, its bias."""
    out = {f"{dst}.weight": np.asarray(sd[f"{src}.weight"])}
    if f"{src}.bias" in sd:
        out[f"{dst}.bias"] = np.asarray(sd[f"{src}.bias"])
    return out


def t_layernorm(sd: Mapping[str, np.ndarray], src: str, dst: str) -> StateDict:
    """An affine LayerNorm: weight and bias."""
    return {f"{dst}.weight": np.asarray(sd[f"{src}.weight"]),
            f"{dst}.bias": np.asarray(sd[f"{src}.bias"])}


def t_rmsnorm(sd: Mapping[str, np.ndarray], src: str, dst: str) -> StateDict:
    """An RMSNorm's scale."""
    return {f"{dst}.weight": np.asarray(sd[f"{src}.weight"])}


def _attn(sd, src: str, dst: str) -> StateDict:
    out: StateDict = {}
    for name in ("q", "k", "v", "o"):
        out.update(t_linear(sd, f"{src}.{name}", f"{dst}.{name}"))
    for name in ("norm_q", "norm_k"):
        out.update(t_rmsnorm(sd, f"{src}.{name}", f"{dst}.{name}"))
    return out


def _convert_block(sd, src: str, dst: str) -> StateDict:
    out = t_layernorm(sd, f"{src}.norm3", f"{dst}.norm3")
    out.update(_attn(sd, f"{src}.self_attn", f"{dst}.self_attn"))
    out.update(_attn(sd, f"{src}.cross_attn", f"{dst}.cross_attn"))
    out.update(t_linear(sd, f"{src}.ffn.0", f"{dst}.ffn.fc1"))
    out.update(t_linear(sd, f"{src}.ffn.2", f"{dst}.ffn.fc2"))
    out[f"{dst}.modulation"] = np.asarray(sd[f"{src}.modulation"])
    return out


def convert_wan(sd: Mapping[str, np.ndarray], cfg: WanConfig) -> StateDict:
    """``WanModel`` state dict -> ``WanTransformer`` state dict."""
    out = t_linear(sd, "patch_embedding", "patch_embedding")
    out.update(t_linear(sd, "text_embedding.0", "text_embedding.fc1"))
    out.update(t_linear(sd, "text_embedding.2", "text_embedding.fc2"))
    out.update(t_linear(sd, "time_embedding.0", "time_embedding.fc1"))
    out.update(t_linear(sd, "time_embedding.2", "time_embedding.fc2"))
    out.update(t_linear(sd, "time_projection.1", "time_projection"))
    for i in range(cfg.num_layers):
        out.update(_convert_block(sd, f"blocks.{i}", f"blocks.{i}"))
    out.update(t_linear(sd, "head.head", "head.head"))
    out["head.modulation"] = np.asarray(sd["head.modulation"])
    return out


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------

# torch Conv3d (O, I, kt, kh, kw) and Conv2d (O, I, kh, kw) weights are the
# port's layouts: a rename, as for a Linear
_t_conv3d = _t_conv2d = t_linear


def _t_rms(sd, src: str, dst: str) -> StateDict:
    """Wan RMS_norm gamma (C, 1, 1[, 1]) -> (C,)."""
    return {f"{dst}.gamma": np.asarray(sd[f"{src}.gamma"]).reshape(-1)}


def _vae_resnet(sd, src: str, dst: str) -> StateDict:
    out = _t_rms(sd, f"{src}.residual.0", f"{dst}.norm1")
    out.update(_t_conv3d(sd, f"{src}.residual.2", f"{dst}.conv1"))
    out.update(_t_rms(sd, f"{src}.residual.3", f"{dst}.norm2"))
    out.update(_t_conv3d(sd, f"{src}.residual.6", f"{dst}.conv2"))
    if f"{src}.shortcut.weight" in sd:
        out.update(_t_conv3d(sd, f"{src}.shortcut", f"{dst}.shortcut"))
    return out


def _vae_resample(sd, src: str, dst: str) -> StateDict:
    out = _t_conv2d(sd, f"{src}.resample.1", f"{dst}.conv")
    if f"{src}.time_conv.weight" in sd:
        out.update(_t_conv3d(sd, f"{src}.time_conv", f"{dst}.time_conv"))
    return out


def _vae_mid(sd, src: str, dst: str) -> StateDict:
    out = _vae_resnet(sd, f"{src}.0", f"{dst}.res1")
    out.update(_t_rms(sd, f"{src}.1.norm", f"{dst}.attn.norm"))
    out.update(_t_conv2d(sd, f"{src}.1.to_qkv", f"{dst}.attn.qkv"))
    out.update(_t_conv2d(sd, f"{src}.1.proj", f"{dst}.attn.proj"))
    out.update(_vae_resnet(sd, f"{src}.2", f"{dst}.res2"))
    return out


def convert_wan_vae(sd: Mapping[str, np.ndarray], cfg: WanConfig,
                    latents_mean: Optional[np.ndarray] = None,
                    latents_std: Optional[np.ndarray] = None) -> StateDict:
    """``Wan2.2_VAE.pth`` (``WanVAE_`` keys, an optional ``model.`` prefix)
    -> ``WanVAE`` state dict.

    ``latents_mean`` / ``latents_std`` are not in the checkpoint: the Wan
    repo hard-codes the 48-channel lists in ``Wan2_2_VAE.__init__`` and
    diffusers ships them in ``vae/config.json``. Omitted, the latents stay
    un-normalized (mean 0, std 1), which is wrong for real weights; callers
    load them beside the state dict."""
    if any(k.startswith("model.") for k in sd):
        sd = {k.removeprefix("model."): v for k, v in sd.items()}
    n, nrb, z = len(cfg.vae_dim_mult), cfg.vae_num_res_blocks, cfg.vae_z_dim

    out = _t_conv3d(sd, "encoder.conv1", "encoder.conv_in")
    for i in range(n):
        src, dst = f"encoder.downsamples.{i}.downsamples", f"encoder.scales.{i}"
        for j in range(nrb):
            out.update(_vae_resnet(sd, f"{src}.{j}", f"{dst}.resnets.{j}"))
        if i != n - 1:
            out.update(_vae_resample(sd, f"{src}.{nrb}", f"{dst}.resample"))
    out.update(_vae_mid(sd, "encoder.middle", "encoder.mid"))
    out.update(_t_rms(sd, "encoder.head.0", "encoder.head_norm"))
    out.update(_t_conv3d(sd, "encoder.head.2", "encoder.conv_out"))

    out.update(_t_conv3d(sd, "decoder.conv1", "decoder.conv_in"))
    out.update(_vae_mid(sd, "decoder.middle", "decoder.mid"))
    for i in range(n):
        src, dst = f"decoder.upsamples.{i}.upsamples", f"decoder.scales.{i}"
        for j in range(nrb + 1):
            out.update(_vae_resnet(sd, f"{src}.{j}", f"{dst}.resnets.{j}"))
        if i != n - 1:
            out.update(_vae_resample(sd, f"{src}.{nrb + 1}", f"{dst}.resample"))
    out.update(_t_rms(sd, "decoder.head.0", "decoder.head_norm"))
    out.update(_t_conv3d(sd, "decoder.head.2", "decoder.conv_out"))

    out.update(_t_conv3d(sd, "conv1", "quant_conv"))
    out.update(_t_conv3d(sd, "conv2", "post_quant_conv"))
    out["latents_mean"] = (np.zeros(z, np.float32) if latents_mean is None
                           else np.asarray(latents_mean, np.float32))
    out["latents_std"] = (np.ones(z, np.float32) if latents_std is None
                          else np.asarray(latents_std, np.float32))
    return out

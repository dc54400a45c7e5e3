"""Weight bridge: the JAX package's parameter trees (as numpy) -> module state.

The inverse of ``videogpa_tpu/convert.py:22-56`` (``t_linear``,
``t_layernorm``, ``t_conv2d``, ``t_conv_transpose2d``):

- Linear:          kernel (in, out)           -> weight (out, in)
- Conv2d:          kernel HWIO (kh, kw, I, O) -> weight OIHW (O, I, kh, kw)
- Conv3d:          kernel DHWIO (pt, ph, pw, I, O) -> weight (O, I, pt, ph, pw)
  (the Wan patch embed)
- ConvTranspose2d: kernel HWIO (k, k, I, O)   -> weight (I, O, k, k), unflipped
  (the DPT's ``resize0`` / ``resize1``, applied by JAX as an einsum)
- LayerNorm:       scale / bias               -> weight / bias
- RMSNorm:         scale                      -> weight
- int8 Linear (``quantize_linear``): w_int8 (in, out) -> w_int8 (out, in),
  w_scale (1, out) -> w_scale (out,); ``load_jax_params`` puts a
  ``QuantLinear`` where the tree holds one

Leaves under a ``lax.scan``-stacked node (``blocks``, ``frame_blocks``,
``global_blocks``, the camera head's ``trunk``) carry every layer along a
leading axis; they are unstacked into ``<node>.{i}.*``. List nodes
(``projects``, ``layer_rn``, ``convs``, ``lins``) become ``<node>.{i}.*``.
Tokens, tables, the Wan blocks' and head's ``modulation`` and the Wan VAE's
``latents_mean`` / ``latents_std`` (``_VERBATIM``), and the ``gamma`` of
LayerScale's ``ls1/ls2`` and of the Wan VAE's RMS norms (``_GAMMA_OWNERS``)
are copied as they are.
Covers the CogVideoX DiT and VAE (5-D conv kernels, GroupNorm
``scale``/``bias``, the ``down``/``up``/``resnets`` lists),
``t5_encoder_init`` (``embed`` and ``rel_bias`` copied), ``wan_init``,
``wan_vae_init``, ``vggt_init`` and ``lpips_init`` trees. Any leaf the
bridge cannot name raises, and loading is strict, so nothing is left
unmapped on either side.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from videogpa_torch.ops.quant import QuantLinear

# leaves copied as they are, by name
_VERBATIM = ("pos_embedding", "camera_token", "register_token", "cls_token",
             "register_tokens", "pos_embed", "empty_pose_tokens", "modulation",
             "embed", "rel_bias", "latents_mean", "latents_std")
# owners whose ``gamma`` is copied as it is: LayerScale, the Wan VAE's RMS norms
_GAMMA_OWNERS = ("ls1", "ls2", "norm1", "norm2", "norm", "head_norm")
# nodes whose leaves stack every layer along a leading axis
_STACKED = ("blocks", "frame_blocks", "global_blocks", "trunk")
# 4-D kernels of transposed convolutions (kernel_size == stride)
_TRANSPOSED_CONVS = ("resize0", "resize1")


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    items = tree.items() if isinstance(tree, Mapping) else enumerate(tree)
    for key, val in items:
        path = f"{prefix}.{key}" if prefix else str(key)
        if isinstance(val, (Mapping, list, tuple)):
            out.update(_flatten(val, path))
        else:
            out[path] = np.asarray(val)
    return out


def _torch_leaf(path: str, arr: np.ndarray):
    """(torch key, array in torch layout) for one unstacked JAX leaf."""
    module, _, name = path.rpartition(".")
    owner = module.rpartition(".")[2]
    if name in _VERBATIM or (name == "gamma" and owner in _GAMMA_OWNERS):
        return path, arr
    if name == "kernel" and arr.ndim == 2:
        return f"{module}.weight", arr.T
    if name == "w_int8" and arr.ndim == 2:
        return path, arr.T
    if name == "w_scale" and arr.ndim == 2 and arr.shape[0] == 1:
        return path, arr[0]
    if name == "kernel" and arr.ndim == 4 and owner in _TRANSPOSED_CONVS:
        return f"{module}.weight", arr.transpose(2, 3, 0, 1)
    if name == "kernel" and arr.ndim == 4:
        return f"{module}.weight", arr.transpose(3, 2, 0, 1)
    if name == "kernel" and arr.ndim == 5:
        return f"{module}.weight", arr.transpose(4, 3, 0, 1, 2)
    if name == "scale" and arr.ndim == 1:
        return f"{module}.weight", arr
    if name == "bias" and arr.ndim == 1:
        return f"{module}.bias", arr
    raise KeyError(f"unmapped JAX leaf {path} with shape {arr.shape}")


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX parameter tree of numpy arrays -> state dict of the port's module."""
    out: Dict[str, np.ndarray] = {}
    for path, arr in _flatten(params).items():
        parts = path.split(".")
        at = next((i for i, p in enumerate(parts) if p in _STACKED), None)
        if at is None:
            key, val = _torch_leaf(path, arr)
            out[key] = val
            continue
        head, rest = ".".join(parts[:at + 1]), ".".join(parts[at + 1:])
        for i in range(arr.shape[0]):
            key, val = _torch_leaf(f"{head}.{i}.{rest}", arr[i])
            out[key] = val
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def load_jax_params(model: nn.Module, params: Mapping[str, Any]) -> nn.Module:
    """Copy a JAX parameter tree into ``model`` (strict: every key on both
    sides). Where the tree holds a quantised linear (``w_int8``), the
    model's ``Linear`` at that place gives way to a ``QuantLinear`` first."""
    sd = state_dict_from_jax(params)
    for key, w in sd.items():
        module, _, name = key.rpartition(".")
        if name != "w_int8":
            continue
        parent_path, _, child = module.rpartition(".")
        parent = model.get_submodule(parent_path)
        old = getattr(parent, child)
        if isinstance(old, nn.Linear):
            setattr(parent, child, QuantLinear(
                w.shape[1], w.shape[0], bias=f"{module}.bias" in sd,
                device=old.weight.device, dtype=old.weight.dtype))
    model.load_state_dict(sd, strict=True)
    return model


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A checkpoint file (.safetensors, or torch .pt/.bin) as numpy; bf16
    tensors widen to f32 (``videogpa_tpu/convert.py::load_torch_state_dict``)."""
    if path.endswith(".safetensors"):
        from videogpa_torch.utils.safetensors_np import load_file

        return load_file(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
            for k, v in sd.items()}

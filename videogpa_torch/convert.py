"""Weight bridge: the JAX package's parameter tree (as numpy) -> module state.

The inverse of ``videogpa_tpu/convert.py:22-56`` (``t_linear``,
``t_layernorm``, ``t_conv2d``):

- Linear:    kernel (in, out)       -> weight (out, in)
- Conv2d:    kernel HWIO (kh, kw, I, O) -> weight OIHW (O, I, kh, kw)
- LayerNorm: scale / bias           -> weight / bias

``params["blocks"]`` holds every block's leaves stacked along a leading
axis; it is unstacked into ``blocks.{i}.*``. Any leaf the bridge cannot name
raises, and loading is strict, so nothing is left unmapped on either side.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

# top-level leaves copied as they are
_VERBATIM = ("pos_embedding",)


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        path = f"{prefix}.{key}" if prefix else key
        if isinstance(val, Mapping):
            out.update(_flatten(val, path))
        else:
            out[path] = np.asarray(val)
    return out


def _torch_leaf(path: str, arr: np.ndarray):
    """(torch key, array in torch layout) for one unstacked JAX leaf."""
    if path in _VERBATIM:
        return path, arr
    module, _, name = path.rpartition(".")
    if name == "kernel" and arr.ndim == 2:
        return f"{module}.weight", arr.T
    if name == "kernel" and arr.ndim == 4:
        return f"{module}.weight", arr.transpose(3, 2, 0, 1)
    if name == "scale" and arr.ndim == 1:
        return f"{module}.weight", arr
    if name == "bias" and arr.ndim == 1:
        return f"{module}.bias", arr
    raise KeyError(f"unmapped JAX leaf {path} with shape {arr.shape}")


def state_dict_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX DiT tree of numpy arrays -> ``CogVideoXTransformer`` state dict."""
    out: Dict[str, np.ndarray] = {}
    for path, arr in _flatten(params).items():
        if not path.startswith("blocks."):
            key, val = _torch_leaf(path, arr)
            out[key] = val
            continue
        for i in range(arr.shape[0]):
            key, val = _torch_leaf(f"blocks.{i}.{path[len('blocks.'):]}", arr[i])
            out[key] = val
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def load_jax_params(model: nn.Module, params: Mapping[str, Any]) -> nn.Module:
    """Copy a JAX parameter tree into ``model`` (strict: every key on both sides)."""
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    return model

"""LoRA adapters for the CogVideoX and Wan DiT attention projections
(``videogpa_tpu/train/lora.py``).

Training config: r=64, alpha=128 on to_q/to_k/to_v/to_out.0. Layout (PEFT):
A is (r, in), B is (out, r); a stacked LoRA tree holds
``{name: {"lora_A": (L, r, in), "lora_B": (L, out, r)}}`` with the layers on
the leading axis, and ``layer_lora`` picks one layer out of it. delta_W =
B @ A, applied as y += scaling * (x @ A^T) @ B^T without merging during
training. Adapters export to (and import from) PEFT's
``adapter_model.safetensors`` + ``adapter_config.json``, byte for byte the
JAX package's files, through the numpy codec ``utils.safetensors_np``.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from videogpa_torch.device import resolve_device
from videogpa_torch.utils import safetensors_np

TARGETS = ("to_q", "to_k", "to_v", "to_out")
# our tree name -> PEFT module path suffix
_PEFT_NAMES = {"to_q": "to_q", "to_k": "to_k", "to_v": "to_v", "to_out": "to_out.0"}


def lora_init(num_layers: int, dim: int, rank: int, generator: torch.Generator,
              device=None, targets: Sequence[str] = TARGETS) -> dict:
    """LoRA params stacked over layers, f32 leaves that require grad:
    A ~ U(-sqrt(3/dim), sqrt(3/dim)) drawn from ``generator`` (which lives on
    ``device``), B = 0 (PEFT init)."""
    device = resolve_device(device)
    bound = math.sqrt(3.0) / math.sqrt(dim)
    params: Dict[str, dict] = {}
    for name in targets:
        a = torch.empty((num_layers, rank, dim), dtype=torch.float32, device=device)
        a.uniform_(-bound, bound, generator=generator)
        b = torch.zeros((num_layers, dim, rank), dtype=torch.float32, device=device)
        params[name] = {"lora_A": a.requires_grad_(True), "lora_B": b.requires_grad_(True)}
    return params


def lora_leaves(lora: dict) -> list:
    """The tree's tensors in a fixed order: per target, A then B."""
    return [ab[k] for ab in lora.values() for k in ("lora_A", "lora_B")]


def layer_lora(lora: Optional[dict], i: int) -> Optional[dict]:
    """Layer ``i`` of a stacked LoRA tree."""
    if lora is None:
        return None
    return {name: {k: t[i] for k, t in ab.items()} for name, ab in lora.items()}


def lora_delta(layer_lora: Optional[dict], name: str, x: torch.Tensor,
               scaling: float) -> torch.Tensor:
    """scaling * (x @ A^T) @ B^T for one layer; each product accumulates in
    f32 and is cast to x's dtype, as in the JAX hook."""
    if layer_lora is None or name not in layer_lora:
        return x.new_zeros(x.shape[:-1] + (0,))
    A = layer_lora[name]["lora_A"].to(x.dtype)
    B = layer_lora[name]["lora_B"].to(x.dtype)
    return scaling * F.linear(F.linear(x, A), B)


# per model family: (attention module of a block, {lora name -> linear name})
_MERGE_LAYOUTS = {
    "cogvideox": ("attn1", {"to_q": "to_q", "to_k": "to_k", "to_v": "to_v", "to_out": "to_out"}),
    "wan": ("self_attn", {"to_q": "q", "to_k": "k", "to_v": "v", "to_out": "o"}),
}


@torch.no_grad()
def merge_lora(model: nn.Module, lora: dict, rank: int, alpha: float, weight: float = 1.0,
               absolute_scaling: Optional[float] = None, layout: str = "cogvideox") -> nn.Module:
    """Merge LoRA into a DiT's attention weights, for sampling; ``layout``
    names the family ("cogvideox" or "wan").

    scaling = ``absolute_scaling`` if given (the CogVideoX1.5 convention),
    else ``weight * alpha / rank`` (PEFT's merge when weight is 1, the
    relative Wan/replicate convention otherwise). Updates ``model`` in place,
    so a 5B model is never held twice, and returns it.
    """
    scaling = absolute_scaling if absolute_scaling is not None else weight * alpha / rank
    attn_key, name_map = _MERGE_LAYOUTS[layout]
    for name, ab in lora.items():
        for i, blk in enumerate(model.blocks):
            lin = getattr(getattr(blk, attn_key), name_map.get(name, name))
            delta = (ab["lora_B"][i].float() @ ab["lora_A"][i].float()) * scaling
            lin.weight.add_(delta.to(device=lin.weight.device, dtype=lin.weight.dtype))
    return model


# ---------------------------------------------------------------------------
# PEFT interop
# ---------------------------------------------------------------------------

def export_peft(
    lora: dict,
    out_dir: str,
    rank: int,
    alpha: float,
    base_model_class: str = "CogVideoXTransformer3DModel",
    parent_library: str = "diffusers.models.transformers.cogvideox_transformer_3d",
    block_prefix: str = "transformer_blocks",
) -> None:
    """Write adapter_model.safetensors + adapter_config.json (PEFT format)."""
    os.makedirs(out_dir, exist_ok=True)
    tensors: Dict[str, np.ndarray] = {}
    num_layers = next(iter(lora.values()))["lora_A"].shape[0]
    for name, lp in lora.items():
        peft_name = _PEFT_NAMES.get(name, name)
        A = lp["lora_A"].detach().float().cpu().numpy()
        B = lp["lora_B"].detach().float().cpu().numpy()
        for i in range(num_layers):
            base = f"base_model.model.{block_prefix}.{i}.attn1.{peft_name}"
            tensors[f"{base}.lora_A.weight"] = A[i]
            tensors[f"{base}.lora_B.weight"] = B[i]
    safetensors_np.save_file(tensors, os.path.join(out_dir, "adapter_model.safetensors"))

    config = {
        "alpha_pattern": {},
        "auto_mapping": {
            "base_model_class": base_model_class,
            "parent_library": parent_library,
        },
        "base_model_name_or_path": None,
        "bias": "none",
        "fan_in_fan_out": False,
        "inference_mode": True,
        "init_lora_weights": True,
        "lora_alpha": alpha,
        "lora_dropout": 0.0,
        "peft_type": "LORA",
        "r": rank,
        "rank_pattern": {},
        "target_modules": [_PEFT_NAMES.get(t, t) for t in lora.keys()],
        "task_type": None,
        "use_dora": False,
        "use_rslora": False,
    }
    with open(os.path.join(out_dir, "adapter_config.json"), "w") as f:
        json.dump(config, f, indent=2)


def import_peft(adapter_dir: str, num_layers: int, block_prefix: str = "transformer_blocks",
                device=None) -> dict:
    """Load a PEFT LoRA adapter directory into the stacked layout (f32
    tensors on ``device``)."""
    device = resolve_device(device)
    tensors = safetensors_np.load_file(os.path.join(adapter_dir, "adapter_model.safetensors"))
    lora: Dict[str, dict] = {}
    for ours, peft_name in _PEFT_NAMES.items():
        a_list, b_list = [], []
        for i in range(num_layers):
            base = f"base_model.model.{block_prefix}.{i}.attn1.{peft_name}"
            a_key, b_key = f"{base}.lora_A.weight", f"{base}.lora_B.weight"
            if a_key not in tensors:
                break
            a_list.append(tensors[a_key])
            b_list.append(tensors[b_key])
        if a_list:
            lora[ours] = {
                "lora_A": torch.from_numpy(np.stack(a_list)).float().to(device),
                "lora_B": torch.from_numpy(np.stack(b_list)).float().to(device),
            }
    return lora

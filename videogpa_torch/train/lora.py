"""LoRA hook of the DiT attention projections (``videogpa_tpu/train/lora.py:60``).

Layout (PEFT): A is (r, in), B is (out, r). A stacked LoRA tree holds
``{name: {"lora_A": (L, r, in), "lora_B": (L, out, r)}}``; ``layer_lora``
picks one layer out of it. The rest of LoRA (init, merge, PEFT files) comes
with the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


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

"""The system under test, ``videogpa_torch``, and what the benchmark reads
of it: its entry points, the launch counters of its attention kernels and
nothing else. Every import of the port happens here or in ``drivers/``,
inside functions, so that a checkout without the port fails at the first
call and the tests here can import the harness.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch


def cogvideox_config(config: dict):
    """The port's ``CogVideoXConfig`` of a configuration file's ``model``."""
    from videogpa_torch.models.cogvideox.config import CogVideoXConfig

    names = {f.name for f in dataclasses.fields(CogVideoXConfig)}
    return CogVideoXConfig(**{k: v for k, v in config["model"].items() if k in names})


def build_dit(config: dict, weights: Dict[str, torch.Tensor]):
    """The port's DiT holding the benchmark's weights (no copy), frozen."""
    from videogpa_torch.models.cogvideox.dit import CogVideoXTransformer

    dtype = next(iter(weights.values())).dtype
    model = CogVideoXTransformer(cogvideox_config(config), device="meta", dtype=dtype)
    model.load_state_dict(weights, strict=True, assign=True)
    return model.requires_grad_(False)


def attention_launches() -> Dict[str, int]:
    """The launch counters of the attention kernels the cells drive."""
    from videogpa_torch.ops import attention

    return {name: getattr(attention, name).launches
            for name in ("flash_attn_fwd", "flash_attn_bwd")}

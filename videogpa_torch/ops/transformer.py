"""The ViT block of DINOv2 and VGGT (``videogpa_tpu/ops/transformer.py``).

Pre-LN block with optional QK-norm, LayerScale and 2D RoPE:
    x = x + ls1 * attn(norm1(x));  x = x + ls2 * ffn(norm2(x))
Attention runs in the (B, N, H, D) layout straight from the qkv projection
(``attention(layout="bnhd")``), which reaches K4 for short rows, K1 for long
ones and K6 at head_dim 128 or in f32; with ``attn_impl="flash_int8"`` long
rows at head_dim < 128 reach K8.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from videogpa_torch.ops import layers as L
from videogpa_torch.ops.attention import attention
from videogpa_torch.ops.rope import rope_2d
from videogpa_torch.parallel.tp import copy_to, gather_from, model_group, row_linear


@dataclasses.dataclass(frozen=True)
class BlockConfig:
    dim: int
    num_heads: int
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    proj_bias: bool = True
    ffn_bias: bool = True
    qk_norm: bool = False
    init_values: Optional[float] = None  # LayerScale init; None = no LayerScale
    rope_base: float = 0.0  # 0 = no rope
    norm_eps: float = 1e-5  # DINOv2 backbones use 1e-6
    ffn: str = "mlp"  # "mlp" | "swiglu"


class LayerScale(nn.Module):
    def __init__(self, dim: int, init_values: float, **fk):
        super().__init__()
        self.init_values = init_values
        self.gamma = nn.Parameter(torch.full((dim,), init_values, **fk))


class Block(nn.Module):
    """The block's parameters, named as the JAX tree; ``forward`` is
    :func:`block_apply`."""

    def __init__(self, cfg: BlockConfig, device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.cfg = cfg
        dim, hd = cfg.dim, cfg.dim // cfg.num_heads
        self.norm1 = L.LayerNorm(dim, eps=cfg.norm_eps, **fk)
        self.attn = L.group(qkv=L.Linear(dim, 3 * dim, bias=cfg.qkv_bias, **fk),
                            proj=L.Linear(dim, dim, bias=cfg.proj_bias, **fk))
        if cfg.qk_norm:
            self.attn.add_module("q_norm", L.LayerNorm(hd, **fk))
            self.attn.add_module("k_norm", L.LayerNorm(hd, **fk))
        self.norm2 = L.LayerNorm(dim, eps=cfg.norm_eps, **fk)
        if cfg.ffn == "swiglu":
            hidden = L.swiglu_hidden(dim, cfg.mlp_ratio)
            self.mlp = L.group(w12=L.Linear(dim, 2 * hidden, bias=cfg.ffn_bias, **fk),
                               w3=L.Linear(hidden, dim, bias=cfg.ffn_bias, **fk))
        else:
            hidden = int(dim * cfg.mlp_ratio)
            self.mlp = L.group(fc1=L.Linear(dim, hidden, bias=cfg.ffn_bias, **fk),
                               fc2=L.Linear(hidden, dim, bias=cfg.ffn_bias, **fk))
        if cfg.init_values is not None:
            self.ls1 = LayerScale(dim, cfg.init_values, **fk)
            self.ls2 = LayerScale(dim, cfg.init_values, **fk)
        else:
            self.ls1 = self.ls2 = None

    def forward(self, x: torch.Tensor, pos: Optional[torch.Tensor] = None,
                attn_impl: str = "auto") -> torch.Tensor:
        return block_apply(self, x, pos, attn_impl)


def self_attention(attn: nn.Module, x: torch.Tensor, cfg: BlockConfig,
                   pos: Optional[torch.Tensor] = None,
                   attn_impl: str = "auto") -> torch.Tensor:
    """x (B, N, C); pos optional (B, N, 2) integer (y, x) for 2D RoPE.

    Under tensor parallelism (a ``vit_param_specs`` shard: each rank holds
    its block of q's, k's and v's rows of the fused qkv) the head count
    follows the local width; a width that cuts a head is gathered to every
    head, and this rank's columns of the output feed the row-parallel proj."""
    B, N, C = x.shape
    D = C // cfg.num_heads
    tp = model_group(attn.qkv, 3 * C, "attn.qkv")
    qkv = attn.qkv(copy_to(x, tp))
    if tp is not None and qkv.shape[-1] // 3 % D:
        qkv = torch.cat([gather_from(t, tp) for t in qkv.chunk(3, dim=-1)], dim=-1)
        gathered = True
    else:
        gathered = False
    H = qkv.shape[-1] // 3 // D
    q, k, v = qkv.reshape(B, N, 3, H, D).unbind(2)  # (B, N, H, D) views
    if cfg.qk_norm:
        q = attn.q_norm(q)
        k = attn.k_norm(k)
    if pos is not None and cfg.rope_base > 0:
        q = rope_2d(q, pos, cfg.rope_base, layout="bnhd")
        k = rope_2d(k, pos, cfg.rope_base, layout="bnhd")
    o = attention(q, k, v, impl=attn_impl, layout="bnhd").reshape(B, N, H * D)
    return row_linear(attn.proj, tp.block(o) if gathered else o, tp)


def block_apply(blk: Block, x: torch.Tensor, pos: Optional[torch.Tensor] = None,
                attn_impl: str = "auto") -> torch.Tensor:
    cfg = blk.cfg
    h = self_attention(blk.attn, blk.norm1(x), cfg, pos, attn_impl)
    if blk.ls1 is not None:
        h = h * blk.ls1.gamma.to(h.dtype)
    x = x + h
    h2 = blk.norm2(x)
    if cfg.ffn == "swiglu":
        h = L.swiglu(blk.mlp, h2)
    else:
        tp = model_group(blk.mlp.fc1, int(cfg.dim * cfg.mlp_ratio), "mlp.fc1")
        h = row_linear(blk.mlp.fc2, L.gelu(blk.mlp.fc1(copy_to(h2, tp))), tp)
    if blk.ls2 is not None:
        h = h * blk.ls2.gamma.to(h.dtype)
    return x + h

"""T5 encoder in PyTorch (``videogpa_tpu/models/t5/encoder.py``): the v1.1
gated-GELU variant and umT5's per-layer relative bias.

RMSNorm, bias-free projections, unscaled attention logits plus a learned
relative-position bucket bias (shared across layers for T5 v1.1, per layer
for umT5) and a ``-1e9`` f32 mask bias, a tanh-GELU gated FFN. The attention
carries an additive bias and no 1/sqrt(D) scale, so it is plain PyTorch
(softmax in f32), not ``ops.attention``. The relative-position buckets are
computed on the host in f32, as one integer table, so the card and the CPU
pick the same bucket.

The module tree mirrors the JAX tree (``embed``, ``layers.{i}.{ln1,q,k,v,o,
ln2,wi_0,wi_1,wo,rel_bias}``, ``final_ln``); ``convert_t5_encoder`` maps a
transformers ``T5EncoderModel`` / ``UMT5EncoderModel`` state dict onto it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from videogpa_torch.device import resolve_device
from videogpa_torch.ops import layers as L


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    per_layer_relative_bias: bool = False  # umT5: True
    layer_norm_eps: float = 1e-6

    @staticmethod
    def t5_v1_1_xxl() -> "T5Config":
        return T5Config()

    @staticmethod
    def umt5_xxl() -> "T5Config":
        return T5Config(vocab_size=256384, per_layer_relative_bias=True)

    @staticmethod
    def tiny(per_layer_bias: bool = False) -> "T5Config":
        return T5Config(
            vocab_size=128, d_model=32, d_kv=8, d_ff=64, num_layers=2,
            num_heads=4, per_layer_relative_bias=per_layer_bias,
        )


class _Layer(nn.Module):
    def __init__(self, cfg: T5Config, with_bias: bool, **fk):
        super().__init__()
        inner, eps = cfg.num_heads * cfg.d_kv, cfg.layer_norm_eps
        self.ln1 = L.RMSNorm(cfg.d_model, eps, **fk)
        self.q = L.Linear(cfg.d_model, inner, bias=False, **fk)
        self.k = L.Linear(cfg.d_model, inner, bias=False, **fk)
        self.v = L.Linear(cfg.d_model, inner, bias=False, **fk)
        self.o = L.Linear(inner, cfg.d_model, bias=False, **fk)
        self.ln2 = L.RMSNorm(cfg.d_model, eps, **fk)
        self.wi_0 = L.Linear(cfg.d_model, cfg.d_ff, bias=False, **fk)
        self.wi_1 = L.Linear(cfg.d_model, cfg.d_ff, bias=False, **fk)
        self.wo = L.Linear(cfg.d_ff, cfg.d_model, bias=False, **fk)
        self.rel_bias = (nn.Parameter(torch.empty(
            (cfg.relative_attention_num_buckets, cfg.num_heads), **fk)) if with_bias else None)


class T5Encoder(nn.Module):
    """The encoder's parameters; ``forward`` is :func:`t5_encode`."""

    def __init__(self, cfg: T5Config, device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.cfg = cfg
        self.embed = nn.Parameter(torch.empty((cfg.vocab_size, cfg.d_model), **fk))
        # layer 0 carries the shared bias; umT5 gives every layer its own
        self.layers = nn.ModuleList(
            _Layer(cfg, cfg.per_layer_relative_bias or i == 0, **fk)
            for i in range(cfg.num_layers))
        self.final_ln = L.RMSNorm(cfg.d_model, cfg.layer_norm_eps, **fk)

    def forward(self, *args, **kwargs) -> torch.Tensor:
        return t5_encode(self, *args, **kwargs)


@torch.no_grad()
def t5_encoder_init(cfg: T5Config, generator: Optional[torch.Generator] = None,
                    device=None, dtype: torch.dtype = torch.float32) -> T5Encoder:
    """Random encoder allocated straight on ``device`` in ``dtype``, with the
    JAX initialiser's distributions: projections U(+-1/sqrt(fan_in)), RMSNorm
    scales 1, the embedding N(0, 1), relative biases N(0, 0.02^2).
    ``generator`` must live on ``device``; the default is seeded with 0."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    model = T5Encoder(cfg, device="meta", dtype=dtype).to_empty(device=device)
    L.kaiming_uniform_init_(model, generator)
    for m in model.modules():
        if isinstance(m, L.RMSNorm):
            m.weight.fill_(1.0)
    model.embed.normal_(generator=generator)
    for layer in model.layers:
        if layer.rel_bias is not None:
            layer.rel_bias.normal_(0.0, 0.02, generator=generator)
    return model.requires_grad_(False)


def _relative_position_bucket(rel_pos: torch.Tensor, num_buckets: int,
                              max_distance: int) -> torch.Tensor:
    """Bidirectional T5 bucket function, in f32 as the JAX package computes
    it (divisions by 0-d f32 tensors: true divisions, as XLA's)."""
    num_buckets //= 2
    ret = (rel_pos > 0).long() * num_buckets
    n = rel_pos.abs()
    max_exact = num_buckets // 2
    is_small = n < max_exact
    f32 = torch.float32
    log_ratio = torch.log(torch.clamp(n, min=1).to(f32) / torch.tensor(max_exact, dtype=f32))
    val = log_ratio / torch.tensor(np.log(max_distance / max_exact), dtype=f32)
    val_large = max_exact + (val * (num_buckets - max_exact)).to(torch.int32).long()
    val_large = torch.clamp(val_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_large)


def _position_bias(rel_bias: torch.Tensor, qlen: int, klen: int, cfg: T5Config) -> torch.Tensor:
    """(1, heads, q, k) bias; the bucket table is computed on the CPU."""
    ctx = torch.arange(qlen)[:, None]
    mem = torch.arange(klen)[None, :]
    buckets = _relative_position_bucket(mem - ctx, cfg.relative_attention_num_buckets,
                                        cfg.relative_attention_max_distance)
    return rel_bias[buckets.to(rel_bias.device)].permute(2, 0, 1)[None]


def t5_encode(model: T5Encoder, input_ids: torch.Tensor,
              attention_mask: Optional[torch.Tensor] = None,
              compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, L) int ids -> (B, L, d_model) final hidden states, on the model's
    device."""
    cfg = model.cfg
    device = model.embed.device
    input_ids = torch.as_tensor(input_ids, device=device).long()
    B, Lq = input_ids.shape
    H, D, eps = cfg.num_heads, cfg.d_kv, cfg.layer_norm_eps
    h = model.embed[input_ids].to(compute_dtype)

    mask_bias = None
    if attention_mask is not None:
        mask = torch.as_tensor(attention_mask, device=device)
        mask_bias = torch.where(mask[:, None, None, :] > 0, 0.0, -1e9).float()

    def heads(y):
        return y.reshape(B, Lq, H, D).transpose(1, 2)

    shared_bias = None
    for i, layer in enumerate(model.layers):
        if layer.rel_bias is not None:
            pos_bias = _position_bias(layer.rel_bias.float(), Lq, Lq, cfg)
            if i == 0:
                shared_bias = pos_bias
        else:
            pos_bias = shared_bias

        x = L.rmsnorm(h, layer.ln1.weight, eps)
        q, k, v = heads(layer.q(x)), heads(layer.k(x)), heads(layer.v(x))
        # T5: unscaled logits + additive position bias, softmax in f32
        s = q.float() @ k.float().transpose(-1, -2) + pos_bias
        if mask_bias is not None:
            s = s + mask_bias
        a = torch.softmax(s, dim=-1).to(v.dtype)
        o = (a.float() @ v.float()).to(compute_dtype)
        h = h + layer.o(o.transpose(1, 2).reshape(B, Lq, H * D))

        x = L.rmsnorm(h, layer.ln2.weight, eps)
        h = h + layer.wo(F.gelu(layer.wi_0(x), approximate="tanh") * layer.wi_1(x))

    return L.rmsnorm(h, model.final_ln.weight, eps)


def convert_t5_encoder(sd: Mapping[str, np.ndarray], cfg: T5Config) -> Dict[str, np.ndarray]:
    """transformers T5EncoderModel / UMT5EncoderModel state dict -> the
    ``T5Encoder`` state dict (the torch layouts are the same; keys change)."""
    pfx = "encoder."
    out: Dict[str, np.ndarray] = {}
    names = {"ln1": "0.layer_norm", "q": "0.SelfAttention.q", "k": "0.SelfAttention.k",
             "v": "0.SelfAttention.v", "o": "0.SelfAttention.o", "ln2": "1.layer_norm",
             "wi_0": "1.DenseReluDense.wi_0", "wi_1": "1.DenseReluDense.wi_1",
             "wo": "1.DenseReluDense.wo"}
    for i in range(cfg.num_layers):
        b = f"{pfx}block.{i}.layer"
        for ours, theirs in names.items():
            out[f"layers.{i}.{ours}.weight"] = np.asarray(sd[f"{b}.{theirs}.weight"])
        bias_key = f"{b}.0.SelfAttention.relative_attention_bias.weight"
        if bias_key in sd:
            out[f"layers.{i}.rel_bias"] = np.asarray(sd[bias_key])
    embed_key = "shared.weight" if "shared.weight" in sd else f"{pfx}embed_tokens.weight"
    out["embed"] = np.asarray(sd[embed_key])
    out["final_ln.weight"] = np.asarray(sd[f"{pfx}final_layer_norm.weight"])
    return out

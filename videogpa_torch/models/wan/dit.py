"""WanModel DiT in PyTorch (``videogpa_tpu/models/wan/dit.py``).

Wan2.2's denoiser: per block a non-affine-LN self-attention with a learned
per-block modulation (6-way, added to the time embedding), text
cross-attention, a gelu-tanh FFN; per-token timesteps for the TI2V
clean-first-frame trick; 3D RoPE with the Wan axis split
(d - 4*(d//6), 2*(d//6), 2*(d//6)) and interleaved pairing.

The module tree mirrors the JAX parameter tree name for name, with the
``lax.scan``-stacked blocks as an ``nn.ModuleList``; ``videogpa_torch.convert``
maps one onto the other. Both attentions go through
``ops.attention.attention`` on ``bhnd`` views of the (B, N, H*D) projections
(the JAX model's layout): at head_dim 128 that is K6 forward and, when the
LoRA requires grad, K7 backward; ``attn_impl="ring"`` splits the sequence
over the ambient mesh's ``seq`` axis (K6/K7 for each pair of shards). A
model that ``parallel.sharding.shard_tree`` split by ``wan_param_specs``
runs tensor-parallel over the mesh's ``model`` axis (``parallel.tp``);
under a ``model`` axis above 1 the residual stream is sequence-sharded
between the blocks (``parallel.sharding.seq_shard``, where JAX constrains
its scan carry), and only the q/k/v projections and the FFN's first see
the whole sequence.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as TF
from torch.utils.checkpoint import checkpoint

from videogpa_torch.device import resolve_device
from videogpa_torch.models.wan.config import WanConfig
from videogpa_torch.ops import layers as L
from videogpa_torch.ops.attention import attention
from videogpa_torch.ops.rope import apply_rope_interleaved, rope_3d_freqs
from videogpa_torch.parallel.mesh import get_mesh, in_mesh
from videogpa_torch.parallel.sharding import seq_shard
from videogpa_torch.parallel.tp import (
    SeqShard, TensorParallel, copy_to, heads_split, lora_block, model_group, row_linear,
    seq_group)
from videogpa_torch.parallel.tp import rmsnorm as tp_rmsnorm
from videogpa_torch.train.lora import layer_lora, lora_delta


def sinusoidal_embedding_1d(dim: int, t: torch.Tensor) -> torch.Tensor:
    """Wan's 1D sinusoidal embedding: cat(cos, sin) over dim/2 freqs."""
    half = dim // 2
    inv = 1.0 / (10000.0 ** (torch.arange(half, dtype=torch.float32, device=t.device) / half))
    freqs = torch.outer(t.float(), inv)
    return torch.cat([torch.cos(freqs), torch.sin(freqs)], dim=-1)


# ---------------------------------------------------------------------------
# Modules (parameter holders named after the JAX tree)
# ---------------------------------------------------------------------------

def _attn_group(d: int, eps: float, **fk) -> nn.Module:
    return L.group(
        q=L.Linear(d, d, **fk), k=L.Linear(d, d, **fk), v=L.Linear(d, d, **fk),
        o=L.Linear(d, d, **fk),
        norm_q=L.RMSNorm(d, eps=eps, **fk), norm_k=L.RMSNorm(d, eps=eps, **fk),
    )


class _Block(nn.Module):
    def __init__(self, cfg: WanConfig, **fk):
        super().__init__()
        d = cfg.dim
        self.norm3 = L.LayerNorm(d, eps=cfg.eps, **fk)  # affine (cross-attn input norm)
        self.self_attn = _attn_group(d, cfg.eps, **fk)
        self.cross_attn = _attn_group(d, cfg.eps, **fk)
        self.ffn = L.group(fc1=L.Linear(d, cfg.ffn_dim, **fk), fc2=L.Linear(cfg.ffn_dim, d, **fk))
        self.modulation = nn.Parameter(torch.empty((1, 6, d), **fk))


class _Head(nn.Module):
    def __init__(self, cfg: WanConfig, **fk):
        super().__init__()
        pt, ph, pw = cfg.patch_size
        self.head = L.Linear(cfg.dim, cfg.out_channels * pt * ph * pw, **fk)
        self.modulation = nn.Parameter(torch.empty((1, 2, cfg.dim), **fk))


class WanTransformer(nn.Module):
    """The DiT's parameters; ``forward`` is :func:`wan_forward`."""

    def __init__(self, cfg: WanConfig, device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.cfg = cfg
        d = cfg.dim
        self.patch_embedding = L.PatchConv3d(cfg.in_channels, d, cfg.patch_size, **fk)
        self.text_embedding = L.group(fc1=L.Linear(cfg.text_dim, d, **fk),
                                      fc2=L.Linear(d, d, **fk))
        self.time_embedding = L.group(fc1=L.Linear(cfg.freq_dim, d, **fk),
                                      fc2=L.Linear(d, d, **fk))
        self.time_projection = L.Linear(d, 6 * d, **fk)
        self.blocks = nn.ModuleList(_Block(cfg, **fk) for _ in range(cfg.num_layers))
        self.head = _Head(cfg, **fk)

    def forward(self, *args, **kwargs) -> torch.Tensor:
        return wan_forward(self, *args, **kwargs)


@torch.no_grad()
def wan_init(cfg: WanConfig, generator: Optional[torch.Generator] = None,
             device=None, dtype: torch.dtype = torch.float32) -> WanTransformer:
    """Random WanModel allocated straight on ``device`` in ``dtype`` (no host
    copy), with the JAX initialisers' distributions: kaiming-uniform linears,
    patch kernel N(0, 0.02^2) with zero bias, modulations N(0, 1/dim), norms
    at one. ``generator`` must live on ``device``; the default is seeded
    with 0."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    model = WanTransformer(cfg, device="meta", dtype=dtype).to_empty(device=device)
    L.kaiming_uniform_init_(model, generator)
    model.patch_embedding.weight.normal_(0.0, 0.02, generator=generator)
    model.patch_embedding.bias.zero_()
    for m in model.modules():
        if isinstance(m, L.RMSNorm):
            m.weight.fill_(1.0)
        if isinstance(m, (_Block, _Head)):
            m.modulation.normal_(0.0, cfg.dim ** -0.5, generator=generator)
    return model


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _ln(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Non-affine LayerNorm in f32, cast back."""
    return L.layernorm(x, eps=eps)


def _heads(y: torch.Tensor, H: int) -> torch.Tensor:
    """(B, N, H*D) -> a (B, H, N, D) view: no copy, the kernels read strides."""
    B, N, C = y.shape
    return y.reshape(B, N, H, C // H).transpose(1, 2)


def _merge_heads(o: torch.Tensor) -> torch.Tensor:
    B, _, N, _ = o.shape
    return o.transpose(1, 2).reshape(B, N, -1)


def _qkv(p: nn.Module, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: WanConfig,
         tp: Optional[TensorParallel]):
    """QK-norm (RMS over the whole width, before the head split: under
    tensor parallelism a sum over the ``model`` group) and the head count of
    the local width; a width that cuts a head is gathered to every head.
    Returns (q, k, v, heads, gathered)."""
    q, k = tp_rmsnorm(q, p.norm_q, tp), tp_rmsnorm(k, p.norm_k, tp)
    (q, gathered), (k, _), (v, _) = (heads_split(y, cfg.head_dim, tp) for y in (q, k, v))
    return q, k, v, q.shape[-1] // cfg.head_dim, gathered


def _seq_in(x: torch.Tensor, tp: Optional[TensorParallel], seq: Optional[SeqShard]):
    """The input of column-parallel layers: Megatron's f, or under sequence
    sharding the whole sequence gathered from the blocks."""
    return copy_to(x, tp) if seq is None else seq.gather(x, tp)


def _seq_reduce(tp: Optional[TensorParallel], seq: Optional[SeqShard]):
    """``row_linear``'s reduce: its own all-reduce (None), or under sequence
    sharding this rank's rows of the sum."""
    return None if seq is None else (lambda y: seq.scatter(y, tp))


def _attn_out(p: nn.Module, o: torch.Tensor, tp: Optional[TensorParallel], gathered: bool,
              delta_fn=None, seq: Optional[SeqShard] = None) -> torch.Tensor:
    """The row-parallel output projection of merged heads ``o``."""
    if gathered:
        o = tp.block(o)
    return row_linear(p.o, o, tp, None if delta_fn is None else delta_fn(o),
                      _seq_reduce(tp, seq))


def _self_attention(p: nn.Module, x: torch.Tensor, cfg: WanConfig,
                    rope: Tuple[torch.Tensor, torch.Tensor],
                    lora: Optional[dict] = None, lora_scaling: float = 1.0,
                    attn_impl: str = "auto", seq: Optional[SeqShard] = None) -> torch.Tensor:
    """``seq``: the ``SeqShard`` of a sequence-sharded stream, whose block
    ``x`` then is; so is the output."""
    tp = model_group(p.q, x.shape[-1], "self_attn.q")
    x = _seq_in(x, tp, seq)
    lora = lora_block(lora, tp)

    def proj(name):
        y = getattr(p, name)(x)
        lname = "to_" + name
        if lora is not None and lname in lora:
            y = y + lora_delta(lora, lname, x, lora_scaling)
        return y

    q, k, v, H, gathered = _qkv(p, proj("q"), proj("k"), proj("v"), cfg, tp)
    cos, sin = rope
    q = apply_rope_interleaved(_heads(q, H), cos, sin)
    k = apply_rope_interleaved(_heads(k, H), cos, sin)
    o = _merge_heads(attention(q, k, _heads(v, H), impl=attn_impl))
    delta_fn = None
    if lora is not None and "to_out" in lora:
        def delta_fn(o):
            return lora_delta(lora, "to_out", o, lora_scaling)
    return _attn_out(p, o, tp, gathered, delta_fn, seq)


def _cross_attention(p: nn.Module, x: torch.Tensor, context: torch.Tensor,
                     cfg: WanConfig, attn_impl: str = "auto",
                     seq: Optional[SeqShard] = None) -> torch.Tensor:
    tp = model_group(p.q, x.shape[-1], "cross_attn.q")
    x, context = _seq_in(x, tp, seq), copy_to(context, tp)
    q, k, v, H, gathered = _qkv(p, p.q(x), p.k(context), p.v(context), cfg, tp)
    o = _merge_heads(attention(_heads(q, H), _heads(k, H), _heads(v, H), impl=attn_impl))
    return _attn_out(p, o, tp, gathered, seq=seq)


def _block_apply(p: nn.Module, x: torch.Tensor, e0: torch.Tensor, context: torch.Tensor,
                 cfg: WanConfig, rope, lora: Optional[dict] = None,
                 lora_scaling: float = 1.0, attn_impl: str = "auto",
                 seq: Optional[SeqShard] = None) -> torch.Tensor:
    """x: (B, L, d), or this rank's block of its sequence under ``seq``;
    e0: (B, L_or_1, 6, d) per-token modulation, f32 (its block likewise)."""
    e = (p.modulation.float()[:, None] + e0.float()).unbind(2)  # 6 x (B, L_or_1, d)

    h = _ln(x, cfg.eps).float() * (1 + e[1]) + e[0]
    y = _self_attention(p.self_attn, h.to(x.dtype), cfg, rope, lora, lora_scaling, attn_impl,
                        seq)
    x = x + (y.float() * e[2]).to(x.dtype)

    x = x + _cross_attention(p.cross_attn, p.norm3(x), context, cfg, attn_impl, seq)

    h = _ln(x, cfg.eps).float() * (1 + e[4]) + e[3]
    tp = model_group(p.ffn.fc1, cfg.ffn_dim, "ffn.fc1")
    y = row_linear(p.ffn.fc2, L.gelu_tanh(p.ffn.fc1(_seq_in(h.to(x.dtype), tp, seq))), tp,
                   reduce=_seq_reduce(tp, seq))
    return x + (y.float() * e[5]).to(x.dtype)


def wan_forward(
    model: WanTransformer,
    x: torch.Tensor,
    t: torch.Tensor,
    context: torch.Tensor,
    remat: bool = False,
    compute_dtype: torch.dtype = torch.bfloat16,
    lora: Optional[dict] = None,
    lora_scaling: float = 1.0,
    attn_impl: str = "auto",
) -> torch.Tensor:
    """WanModel forward.

    Args:
        x: (B, C, F, H, W) noisy latents.
        t: (B,) or (B, L) timesteps (per-token for TI2V).
        context: (B, text_len, text_dim) umT5 features (zero-padded).
        remat: keep only each block's inputs for the backward and recompute
            the block there (``torch.utils.checkpoint``), as the JAX
            package's ``jax.checkpoint`` of the scan body does.
        lora: optional stacked LoRA tree (``videogpa_torch.train.lora``) on
            the self-attention projections of every block.
        attn_impl: ``ops.attention.attention``'s ``impl``; at head_dim 128
            "flash_int8" takes the exact kernel, as "flash" does.

    Returns:
        (B, out_channels, F, H, W) float32 velocity prediction.
    """
    cfg = model.cfg
    B, _, F, H, W = x.shape
    pt, ph, pw = cfg.patch_size
    d = cfg.dim
    grid = (F // pt, H // ph, W // pw)

    # patch embed: conv3d with stride = patch; tokens in (f, h, w) order
    h = model.patch_embedding(x.to(compute_dtype))  # (B, L, d)

    # time embedding (f32), optionally per token
    te = model.time_embedding
    temb = sinusoidal_embedding_1d(cfg.freq_dim, t.reshape(-1))
    temb = te.fc2(TF.silu(te.fc1(temb)))
    e0 = model.time_projection(TF.silu(temb))
    n_t = t.shape[1] if t.ndim == 2 else 1
    e0 = e0.reshape(B, n_t, 6, d)
    temb = temb.reshape(B, n_t, d)

    txt = model.text_embedding
    ctx = txt.fc2(L.gelu_tanh(txt.fc1(context.to(compute_dtype))))

    rope = rope_3d_freqs(grid, cfg.head_dim, cfg.rope_theta, cfg.rope_axis_dims,
                         device=h.device)

    # under a model axis above 1 the stream (and a per-token e0) is
    # sequence-sharded between the blocks, so remat keeps 1/tp of it
    sp = seq_group()
    seq = None if sp is None else SeqShard(sp, h.shape[1])
    e_blk = e0 if seq is None or n_t == 1 else seq_shard(e0)
    h = seq_shard(h)
    for i, blk in enumerate(model.blocks):
        args = (blk, h, e_blk, ctx, cfg, rope, layer_lora(lora, i), lora_scaling, attn_impl, seq)
        if remat:
            # the recompute runs under this mesh (``in_mesh``); no block draws
            # random numbers, so there is no RNG state to keep for it
            h = checkpoint(in_mesh, get_mesh(), _block_apply, *args, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            h = _block_apply(*args)
    if seq is not None:
        h = seq.gather(h, None)

    # head: modulated non-affine LN + linear
    he = model.head.modulation.float()[:, None] + temb[:, :, None].float()  # (B, L_or_1, 2, d)
    out = _ln(h, cfg.eps).float() * (1 + he[:, :, 1]) + he[:, :, 0]
    out = model.head.head(out.to(compute_dtype))

    # unpatchify: (B, L, pt*ph*pw*C_out) -> (B, C_out, F, H, W)
    out = out.reshape(B, grid[0], grid[1], grid[2], pt, ph, pw, cfg.out_channels)
    out = out.permute(0, 7, 1, 4, 2, 5, 3, 6).reshape(B, cfg.out_channels, F, H, W)
    return out.float()

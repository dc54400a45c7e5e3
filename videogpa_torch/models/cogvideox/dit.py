"""CogVideoX DiT (Transformer3D) in PyTorch (``videogpa_tpu/models/cogvideox/dit.py``).

Same architecture as diffusers' ``CogVideoXTransformer3DModel``: a joint
text+video token stream; per-block AdaLN ("LayerNormZero") from the time
embedding; one fused self-attention over [text ‖ video] with per-head QK
LayerNorm (eps 1e-6) and 3D RoPE on the video tokens; a gelu-tanh FFN; final
LayerNorm + AdaLN + linear unpatchify.

The module tree mirrors the JAX parameter tree name for name, with the
``lax.scan``-stacked blocks as an ``nn.ModuleList``; ``videogpa_torch.convert``
maps one onto the other. Attention goes through ``ops.attention.attention``,
which launches the hand-written flash kernel on CUDA tensors;
``attn_impl="ring"`` splits the sequence over the ambient mesh's ``seq``
axis. A DiT that ``parallel.sharding.shard_tree`` split by
``dit_param_specs`` runs tensor-parallel over the mesh's ``model`` axis
(``parallel.tp``): each rank attends with the heads of its q/k/v rows.
Under a ``model`` axis above 1 the two residual streams (text and video)
are sequence-sharded between the blocks (``parallel.sharding.seq_shard``,
where JAX constrains its scan carries): each rank keeps its block of each,
and only the q/k/v projections and the FFN's first see the whole sequence.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as TF
from torch.utils.checkpoint import checkpoint

from videogpa_torch.device import resolve_device
from videogpa_torch.models.cogvideox.config import CogVideoXConfig
from videogpa_torch.ops import layers as L
from videogpa_torch.ops.attention import attention
from videogpa_torch.ops.rope import apply_rope_interleaved, rope_3d_freqs
from videogpa_torch.parallel.mesh import get_mesh, in_mesh
from videogpa_torch.parallel.sharding import seq_shard
from videogpa_torch.parallel.tp import (
    SeqShard, copy_to, heads_split, lora_block, model_group, row_linear, seq_group)
from videogpa_torch.train.lora import layer_lora, lora_delta


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------

def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """diffusers get_timestep_embedding with flip_sin_to_cos=True, shift=0."""
    half = dim // 2
    exponent = (-math.log(max_period)
                * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    emb = timesteps.float()[:, None] * torch.exp(exponent)[None]
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)


def _sincos_1d(dim: int, pos: torch.Tensor) -> torch.Tensor:
    omega = torch.arange(dim // 2, dtype=torch.float32) / (dim / 2.0)
    omega = 1.0 / (10000.0 ** omega)
    out = pos.reshape(-1)[:, None] * omega[None]
    return torch.cat([torch.sin(out), torch.cos(out)], dim=1)


def sincos_pos_embed_3d(embed_dim: int, t: int, h: int, w: int,
                        spatial_scale: float = 1.875,
                        temporal_scale: float = 1.0) -> torch.Tensor:
    """3D sincos pos-embed, (T*H*W, embed_dim): 3/4 spatial + 1/4 temporal."""
    dim_s = embed_dim // 4 * 3
    dim_t = embed_dim // 4
    ys = torch.arange(h, dtype=torch.float32) / spatial_scale
    xs = torch.arange(w, dtype=torch.float32) / spatial_scale
    gy = ys.repeat_interleave(w)
    gx = xs.repeat(h)
    # diffusers' MAE-inherited quirk: the first spatial half embeds the W
    # coordinate (np.meshgrid(grid_w, grid_h) feeds "emb_h")
    spatial = torch.cat([_sincos_1d(dim_s // 2, gx), _sincos_1d(dim_s // 2, gy)], dim=1)
    ts = torch.arange(t, dtype=torch.float32) / temporal_scale
    temporal = _sincos_1d(dim_t, ts)
    spatial = spatial[None].expand(t, h * w, dim_s)
    temporal = temporal[:, None].expand(t, h * w, dim_t)
    return torch.cat([temporal, spatial], dim=-1).reshape(t * h * w, embed_dim)


# ---------------------------------------------------------------------------
# Modules (parameter holders named after the JAX tree)
# ---------------------------------------------------------------------------

def _group(**children: nn.Module) -> nn.Module:
    m = nn.Module()
    for name, child in children.items():
        m.add_module(name, child)
    return m


class _Block(nn.Module):
    def __init__(self, cfg: CogVideoXConfig, **fk):
        super().__init__()
        dim, hd, te = cfg.hidden_dim, cfg.head_dim, cfg.time_embed_dim
        self.norm1 = _group(linear=L.Linear(te, 6 * dim, **fk), norm=L.LayerNorm(dim, **fk))
        self.attn1 = _group(
            to_q=L.Linear(dim, dim, **fk), to_k=L.Linear(dim, dim, **fk),
            to_v=L.Linear(dim, dim, **fk), to_out=L.Linear(dim, dim, **fk),
            norm_q=L.LayerNorm(hd, eps=1e-6, **fk), norm_k=L.LayerNorm(hd, eps=1e-6, **fk),
        )
        self.norm2 = _group(linear=L.Linear(te, 6 * dim, **fk), norm=L.LayerNorm(dim, **fk))
        self.ff = _group(fc1=L.Linear(dim, 4 * dim, **fk), fc2=L.Linear(4 * dim, dim, **fk))


class CogVideoXTransformer(nn.Module):
    """The DiT's parameters; ``forward`` is :func:`dit_forward`."""

    def __init__(self, cfg: CogVideoXConfig, device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.cfg = cfg
        dim, p, te = cfg.hidden_dim, cfg.patch_size, cfg.time_embed_dim
        if cfg.patch_size_t is None:
            proj = L.Conv2d(cfg.in_channels, dim, kernel_size=p, stride=p, **fk)
        else:
            proj = L.Linear(cfg.in_channels * cfg.patch_size_t * p * p, dim, **fk)
        self.patch_embed = _group(proj=proj, text_proj=L.Linear(cfg.text_embed_dim, dim, **fk))
        self.time_embedding = _group(linear_1=L.Linear(dim, te, **fk),
                                     linear_2=L.Linear(te, te, **fk))
        self.blocks = nn.ModuleList(_Block(cfg, **fk) for _ in range(cfg.num_layers))
        self.norm_final = L.LayerNorm(dim, **fk)
        self.norm_out = _group(linear=L.Linear(te, 2 * dim, **fk), norm=L.LayerNorm(dim, **fk))
        self.proj_out = L.Linear(dim, (cfg.patch_size_t or 1) * p * p * cfg.out_channels, **fk)
        if cfg.ofs_embed_dim is not None:
            od = cfg.ofs_embed_dim
            self.ofs_embedding = _group(linear_1=L.Linear(od, od, **fk),
                                        linear_2=L.Linear(od, od, **fk))
        else:
            self.ofs_embedding = None
        if not cfg.use_rotary_positional_embeddings or cfg.use_learned_positional_embeddings:
            n = cfg.max_text_seq_length + (
                cfg.sample_frames * (cfg.sample_height // p) * (cfg.sample_width // p))
            self.pos_embedding = nn.Parameter(torch.empty((1, n, dim), **fk))
        else:
            self.pos_embedding = None

    def forward(self, *args, **kwargs) -> torch.Tensor:
        return dit_forward(self, *args, **kwargs)


@torch.no_grad()
def dit_init(cfg: CogVideoXConfig, generator: Optional[torch.Generator] = None,
             device=None, dtype: torch.dtype = torch.float32) -> CogVideoXTransformer:
    """Random DiT allocated straight on ``device`` in ``dtype`` (no host copy):
    kaiming-uniform bounds of the JAX initialisers, sincos position table.
    ``generator`` must live on ``device``; the default is seeded with 0."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    model = CogVideoXTransformer(cfg, device="meta", dtype=dtype).to_empty(device=device)
    L.kaiming_uniform_init_(model, generator)
    if model.pos_embedding is not None:
        p = cfg.patch_size
        img = sincos_pos_embed_3d(cfg.hidden_dim, cfg.sample_frames,
                                  cfg.sample_height // p, cfg.sample_width // p)
        model.pos_embedding.zero_()
        model.pos_embedding[0, cfg.max_text_seq_length:] = img.to(device=device, dtype=dtype)
    return model


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _adaln_zero(p: nn.Module, temb: torch.Tensor, hidden: torch.Tensor,
                encoder: torch.Tensor):
    """CogVideoXLayerNormZero: 6-way AdaLN over both streams."""
    mod = p.linear(TF.silu(temb))  # (B, 6*dim)
    shift, scale, gate, e_shift, e_scale, e_gate = mod.chunk(6, dim=-1)
    h = p.norm(hidden) * (1 + scale[:, None]) + shift[:, None]
    e = p.norm(encoder) * (1 + e_scale[:, None]) + e_shift[:, None]
    return h, e, gate[:, None], e_gate[:, None]


def _joint_in(encoder: torch.Tensor, hidden: torch.Tensor, tp, seq) -> torch.Tensor:
    """[text ‖ video], the input of column-parallel layers: Megatron's f,
    or under sequence sharding each stream gathered from its blocks."""
    if seq is None:
        return copy_to(torch.cat([encoder, hidden], dim=1), tp)
    return torch.cat([seq[0].gather(encoder, tp), seq[1].gather(hidden, tp)], dim=1)


def _joint_reduce(tp, seq):
    """The sum of a row-parallel layer's partial outputs over [text ‖
    video]: ``row_linear``'s own all-reduce (None), or under sequence
    sharding [this rank's text rows ‖ its video rows]."""
    if seq is None:
        return None
    n_txt = seq[0].n

    def reduce(y):
        return torch.cat([seq[0].scatter(y[:, :n_txt], tp), seq[1].scatter(y[:, n_txt:], tp)],
                         dim=1)
    return reduce


def _joint_attention(
    p: nn.Module,
    hidden: torch.Tensor,
    encoder: torch.Tensor,
    cfg: CogVideoXConfig,
    rope: Optional[Tuple[torch.Tensor, torch.Tensor]],
    lora: Optional[dict] = None,
    lora_scaling: float = 1.0,
    attn_layout: str = "bhnd",
    attn_impl: str = "auto",
    seq: Optional[Tuple[SeqShard, SeqShard]] = None,
):
    """``seq``: the (text, video) ``SeqShard`` of sequence-sharded streams,
    whose blocks ``encoder`` and ``hidden`` then are; the outputs are this
    rank's blocks too."""
    C = hidden.shape[-1]
    D = cfg.head_dim
    # tensor parallel where shard_tree split to_q's rows: this rank's heads
    tp = model_group(p.to_q, C, "attn1.to_q")
    x = _joint_in(encoder, hidden, tp, seq)
    B = x.shape[0]
    N_txt = encoder.shape[1] if seq is None else seq[0].n  # the whole text stream
    lora = lora_block(lora, tp)

    def proj(name):
        y = getattr(p, name)(x)
        if lora is not None and name in lora:
            y = y + lora_delta(lora, name, x, lora_scaling)
        return y

    # the head count follows the local width; a width that cuts a head is
    # gathered to every head (``heads_split``), this rank's columns kept after
    (q, gathered), (k, _), (v, _) = (heads_split(proj(n), D, tp) for n in ("to_q", "to_k", "to_v"))
    H = q.shape[-1] // D

    if attn_layout == "bnhd":
        # inference path: (B, N, H, D) straight from the projections into the
        # kernel, which reads strides; QK-norm is over D and RoPE broadcasts
        # over H, so no transpose is needed anywhere
        def heads(y):
            return y.reshape(B, -1, H, D)
    else:
        def heads(y):
            return y.reshape(B, -1, H, D).transpose(1, 2)

    q = p.norm_q(heads(q))
    k = p.norm_k(heads(k))
    v = heads(v)

    if rope is not None:
        cos, sin = rope
        if attn_layout == "bnhd":
            cos, sin = cos[:, None], sin[:, None]  # broadcast over H
            q = torch.cat([q[:, :N_txt], apply_rope_interleaved(q[:, N_txt:], cos, sin)], dim=1)
            k = torch.cat([k[:, :N_txt], apply_rope_interleaved(k[:, N_txt:], cos, sin)], dim=1)
        else:
            q = torch.cat([q[:, :, :N_txt],
                           apply_rope_interleaved(q[:, :, N_txt:], cos, sin)], dim=2)
            k = torch.cat([k[:, :, :N_txt],
                           apply_rope_interleaved(k[:, :, N_txt:], cos, sin)], dim=2)

    o = attention(q, k, v, impl=attn_impl, layout=attn_layout)
    if attn_layout != "bnhd":
        o = o.transpose(1, 2)
    o = o.reshape(B, x.shape[1], H * D)
    if gathered:
        o = tp.block(o)
    delta = (lora_delta(lora, "to_out", o, lora_scaling)
             if lora is not None and "to_out" in lora else None)
    out = row_linear(p.to_out, o, tp, delta, _joint_reduce(tp, seq))
    n_txt = encoder.shape[1]
    return out[:, n_txt:], out[:, :n_txt]


def _block_apply(p, hidden, encoder, temb, cfg, rope,
                 lora=None, lora_scaling=1.0, attn_layout="bhnd", attn_impl="auto", seq=None):
    h_n, e_n, gate, e_gate = _adaln_zero(p.norm1, temb, hidden, encoder)
    attn_h, attn_e = _joint_attention(
        p.attn1, h_n, e_n, cfg, rope, lora, lora_scaling, attn_layout, attn_impl, seq,
    )
    hidden = hidden + gate * attn_h
    encoder = encoder + e_gate * attn_e

    h_n, e_n, gate, e_gate = _adaln_zero(p.norm2, temb, hidden, encoder)
    tp = model_group(p.ff.fc1, 4 * hidden.shape[-1], "ff.fc1")
    x = _joint_in(e_n, h_n, tp, seq)
    n_txt = encoder.shape[1]
    ff = row_linear(p.ff.fc2, L.gelu_tanh(p.ff.fc1(x)), tp, reduce=_joint_reduce(tp, seq))
    hidden = hidden + gate * ff[:, n_txt:]
    encoder = encoder + e_gate * ff[:, :n_txt]
    return hidden, encoder


def dit_forward(
    model: CogVideoXTransformer,
    hidden_states: torch.Tensor,
    encoder_hidden_states: torch.Tensor,
    timestep: torch.Tensor,
    ofs: Optional[torch.Tensor] = None,
    compute_dtype: torch.dtype = torch.bfloat16,
    lora: Optional[dict] = None,
    lora_scaling: float = 1.0,
    attn_layout: str = "bhnd",
    remat: bool = False,
    attn_impl: str = "auto",
) -> torch.Tensor:
    """CogVideoX DiT forward.

    Args:
        hidden_states: (B, F, C, H, W) latent video (diffusers layout).
        encoder_hidden_states: (B, L, text_embed_dim) T5 features.
        timestep: (B,) integer timesteps.
        lora: optional stacked LoRA tree (``videogpa_torch.train.lora``)
            applied to the attention projections of every block; gradients
            reach the stacked tensors through the per-layer slices.
        attn_impl: ``ops.attention.attention``'s ``impl``; "flash_int8" is the
            inference-only int8-QK mode and raises under grad.
        remat: keep only each block's inputs for the backward and recompute
            the block there (``torch.utils.checkpoint``), as the JAX
            package's ``jax.checkpoint`` of the scan body does.

    Returns:
        (B, F, out_channels, H, W) float32 prediction (v-prediction).
    """
    cfg = model.cfg
    B, Fr, C, Hh, Ww = hidden_states.shape
    p = cfg.patch_size
    pt = cfg.patch_size_t
    dim = cfg.hidden_dim

    hidden_states = hidden_states.to(compute_dtype)
    encoder = model.patch_embed.text_proj(encoder_hidden_states.to(compute_dtype))

    # 1. time embedding (f32 for stability)
    te = model.time_embedding
    temb = te.linear_2(TF.silu(te.linear_1(timestep_embedding(timestep, dim))))
    if ofs is not None and model.ofs_embedding is not None:
        oe = model.ofs_embedding
        temb = temb + oe.linear_2(TF.silu(oe.linear_1(
            timestep_embedding(ofs, cfg.ofs_embed_dim))))
    temb = temb.to(compute_dtype)

    # 2. patchify
    if pt is None:
        x = model.patch_embed.proj(hidden_states.reshape(B * Fr, C, Hh, Ww))
        x = x.reshape(B, Fr, dim, -1).transpose(2, 3).reshape(B, -1, dim)
        grid_t, grid_h, grid_w = Fr, Hh // p, Ww // p
    else:
        grid_t, grid_h, grid_w = Fr // pt, Hh // p, Ww // p
        x = hidden_states.reshape(B, grid_t, pt, C, grid_h, p, grid_w, p)
        x = x.permute(0, 1, 4, 6, 2, 3, 5, 7).reshape(
            B, grid_t * grid_h * grid_w, pt * C * p * p)
        x = model.patch_embed.proj(x)

    if model.pos_embedding is not None:
        n_txt = cfg.max_text_seq_length
        joint = torch.cat([encoder, x], dim=1)
        joint = joint + model.pos_embedding.to(compute_dtype)[:, : joint.shape[1]]
        encoder, x = joint[:, :n_txt], joint[:, n_txt:]

    rope = None
    if cfg.use_rotary_positional_embeddings:
        rope = rope_3d_freqs((grid_t, grid_h, grid_w), cfg.head_dim, cfg.rope_theta,
                             device=x.device)

    # 3. transformer blocks; under a model axis above 1 the streams are
    # sequence-sharded between them, so remat keeps 1/tp of each
    sp = seq_group()
    seq = None if sp is None else (SeqShard(sp, encoder.shape[1]), SeqShard(sp, x.shape[1]))
    x, encoder = seq_shard(x), seq_shard(encoder)
    for i, blk in enumerate(model.blocks):
        args = (blk, x, encoder, temb, cfg, rope, layer_lora(lora, i), lora_scaling,
                attn_layout, attn_impl, seq)
        if remat:
            # the recompute runs under this mesh (``in_mesh``); no block draws
            # random numbers, so there is no RNG state to keep for it
            x, encoder = checkpoint(in_mesh, get_mesh(), _block_apply, *args,
                                    use_reentrant=False, preserve_rng_state=False)
        else:
            x, encoder = _block_apply(*args)
    if seq is not None:
        encoder, x = seq[0].gather(encoder, None), seq[1].gather(x, None)

    # 4. output head
    n_txt = encoder.shape[1]
    joint = model.norm_final(torch.cat([encoder, x], dim=1))
    x = joint[:, n_txt:]
    shift, scale = model.norm_out.linear(TF.silu(temb)).chunk(2, dim=-1)
    x = model.norm_out.norm(x) * (1 + scale[:, None]) + shift[:, None]
    x = model.proj_out(x)

    # 5. unpatchify
    if pt is None:
        x = x.reshape(B, Fr, grid_h, grid_w, cfg.out_channels, p, p)
        x = x.permute(0, 1, 4, 2, 5, 3, 6)
    else:
        x = x.reshape(B, grid_t, grid_h, grid_w, pt, cfg.out_channels, p, p)
        x = x.permute(0, 1, 4, 5, 2, 6, 3, 7)
    return x.reshape(B, Fr, cfg.out_channels, grid_h * p, grid_w * p).float()

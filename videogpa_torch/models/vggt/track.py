"""VGGT's track head (``videogpa_tpu/models/vggt/track.py``): a DPT feature
extractor (feature-only, width 128, down ratio 2) feeding a CoTracker-style
tracker: correlation-pyramid sampling around the current track positions,
an update former (time attention along each track, space attention through
64 virtual tracks) predicting coordinate and feature deltas over a few
refinement iterations, then visibility and confidence heads.

The trackers' attention is XLA code in the JAX package (einsum, softmax,
einsum), so here it is plain PyTorch, not ``ops/attention.py``. Kept as
the reference has them, for its checkpoints:

- the attention blocks reassign ``x = norm1(x)`` before the residual, with
  affine layer norms of eps 1e-5;
- the correlation MLP and the feature updater use the tanh GELU (JAX's
  default ``jax.nn.gelu``); the blocks' MLPs the exact one;
- correlations are sampled at align-corners pixel coordinates with zeros
  outside, features clamped to the border; the window's x offset varies
  along its first axis;
- the pyramid's 2x2 average pool floors odd sizes (259 -> 129 -> ... -> 4).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn as nn

from videogpa_torch.device import resolve_device
from videogpa_torch.models.vggt.config import VGGTConfig
from videogpa_torch.models.vggt.heads import DPTHead, dpt_head_forward
from videogpa_torch.ops import layers as L
from videogpa_torch.ops.resize import grid_sample_bilinear

# parameters drawn N(0, 1) by the JAX initialisers (``jax.random.normal``)
_NORMAL_LEAVES = ("virtual_tracks", "query_ref_token")


# ---------------------------------------------------------------------------
# Embeddings and samplers
# ---------------------------------------------------------------------------

def get_2d_sincos_pos_embed(embed_dim: int, grid_hw: Tuple[int, int],
                            device=None) -> torch.Tensor:
    """(1, embed_dim, H, W); CoTracker's layout (the x grid's half first)."""
    H, W = grid_hw
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                            torch.arange(W, dtype=torch.float32, device=device),
                            indexing="ij")

    def emb_1d(pos, dim):
        omega = torch.arange(dim // 2, dtype=torch.float32, device=device) / (dim / 2.0)
        omega = 1.0 / 10000 ** omega
        out = pos.reshape(-1)[:, None] * omega[None]
        return torch.cat([torch.sin(out), torch.cos(out)], dim=1)

    emb = torch.cat([emb_1d(xs, embed_dim // 2), emb_1d(ys, embed_dim // 2)], dim=1)
    return emb.reshape(1, H, W, embed_dim).permute(0, 3, 1, 2)


def get_2d_embedding(xy: torch.Tensor, C: int, cat_coords: bool = True) -> torch.Tensor:
    """(B, N, 2) -> (B, N, 2C [+2]); sin and cos interleaved for each axis."""
    x, y = xy[..., 0:1], xy[..., 1:2]
    div = (torch.arange(0, C, 2, dtype=torch.float32, device=xy.device) * (1000.0 / C))

    def interleave(t):
        out = torch.stack([torch.sin(t * div), torch.cos(t * div)], dim=-1)
        return out.reshape(out.shape[:-2] + (C,))

    pe = torch.cat([interleave(x), interleave(y)], dim=-1)
    return torch.cat([xy, pe], dim=-1) if cat_coords else pe


def _sample_map(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                padding: str) -> torch.Tensor:
    """Maps (B, C..., H, W) sampled at pixel coordinates u, v (B, M) with
    align-corners semantics -> (B, C..., M): for each batch entry and
    channel, JAX's ``_sample_map`` of one (H, W) map, that is
    ``grid_sample_bilinear`` (zeros outside), ``"border"`` clamping the
    coordinates first."""
    H, W = img.shape[-2:]
    if padding == "border":
        u = u.clamp(0, W - 1)
        v = v.clamp(0, H - 1)
    out = grid_sample_bilinear(img.movedim((-2, -1), (1, 2)), u, v, batched=True)
    return out.movedim(1, -1)


def sample_features4d(fmap: torch.Tensor, coords: torch.Tensor,
                      padding: str = "border") -> torch.Tensor:
    """fmap (B, C, H, W), coords (B, N, 2) xy pixels -> (B, N, C)."""
    return _sample_map(fmap, coords[..., 0], coords[..., 1], padding).transpose(1, 2)


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 mean, odd sizes floored as ``F.avg_pool2d`` does."""
    B, C, H, W = x.shape
    x = x[:, :, : H // 2 * 2, : W // 2 * 2]
    return x.reshape(B, C, H // 2, 2, W // 2, 2).mean(dim=(3, 5))


def corr_pyramid_sample(fmaps: torch.Tensor, targets: torch.Tensor, coords: torch.Tensor,
                        num_levels: int, radius: int) -> torch.Tensor:
    """fmaps (B, S, C, H, W); targets (B, S, N, C); coords (B, S, N, 2)
    pixels -> (B, S, N, num_levels * (2r+1)^2) sampled correlations. At
    window slot (i, j) the sample is (x + d[i], y + d[j]): the x offset
    varies along the window's first axis, as the reference's
    ``CorrBlock`` adds its (dy, dx) meshgrid to (x, y)."""
    B, S, C, H, W = fmaps.shape
    N = targets.shape[2]
    k = 2 * radius + 1
    d = torch.arange(-radius, radius + 1, dtype=coords.dtype, device=coords.device)
    dyx = torch.stack(torch.meshgrid(d, d, indexing="ij"), dim=-1)  # (k, k, 2)
    out = []
    fm = fmaps
    for lvl in range(num_levels):
        Hc, Wc = fm.shape[-2:]
        corr = torch.einsum("bsnc,bschw->bsnhw", targets, fm) / math.sqrt(C)
        centers = coords / (2 ** lvl)
        sample_xy = (centers[:, :, :, None, None, :] + dyx).reshape(B * S * N, k * k, 2)
        sampled = _sample_map(corr.reshape(B * S * N, Hc, Wc), sample_xy[..., 0],
                              sample_xy[..., 1], "zeros")
        out.append(sampled.reshape(B, S, N, k * k))
        if lvl + 1 < num_levels:
            fm = _avg_pool2(fm.reshape(B * S, C, Hc, Wc)).reshape(B, S, C, Hc // 2, Wc // 2)
    return torch.cat(out, dim=-1)


# ---------------------------------------------------------------------------
# Update former
# ---------------------------------------------------------------------------

def mha_module(dim: int, **fk) -> nn.Module:
    """``nn.MultiheadAttention``'s parameters: a fused (3·dim) input
    projection and the output projection."""
    return L.group(in_proj=L.Linear(dim, 3 * dim, **fk), out_proj=L.Linear(dim, dim, **fk))


def mlp_module(dim: int, hidden: int, out: Optional[int] = None, **fk) -> nn.Module:
    return L.group(fc1=L.Linear(dim, hidden, **fk), fc2=L.Linear(hidden, out or dim, **fk))


def _mha(m: nn.Module, q_in: torch.Tensor, kv_in: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain attention: softmax(QKᵀ/√d)V over (Bn, N, D) tokens."""
    D = q_in.shape[-1]
    w, b = m.in_proj.weight, m.in_proj.bias
    q = L.linear(q_in, w[:D], b[:D])
    k = L.linear(kv_in, w[D:2 * D], b[D:2 * D])
    v = L.linear(kv_in, w[2 * D:], b[2 * D:])

    def heads(x):
        Bn, N, _ = x.shape
        return x.reshape(Bn, N, num_heads, D // num_heads).transpose(1, 2)

    s = torch.matmul(heads(q), heads(k).transpose(-1, -2)).float() * (D // num_heads) ** -0.5
    a = torch.softmax(s, dim=-1)
    o = torch.matmul(a.to(v.dtype), heads(v))
    Bn, _, N, _ = o.shape
    return m.out_proj(o.transpose(1, 2).reshape(Bn, N, D))


def _attn_block_module(dim: int, **fk) -> nn.Module:
    return L.group(norm1=L.LayerNorm(dim, **fk), norm2=L.LayerNorm(dim, **fk),
                   attn=mha_module(dim, **fk), mlp=mlp_module(dim, dim * 4, **fk))


def _attn_block(m: nn.Module, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    x = m.norm1(x)  # the reference reassigns x before the residual
    x = x + _mha(m.attn, x, x, num_heads)
    return x + L.mlp(m.mlp, m.norm2(x))


def _cross_block_module(dim: int, **fk) -> nn.Module:
    m = _attn_block_module(dim, **fk)
    m.add_module("norm_context", L.LayerNorm(dim, **fk))
    return m


def _cross_block(m: nn.Module, x: torch.Tensor, context: torch.Tensor,
                 num_heads: int) -> torch.Tensor:
    x = m.norm1(x)
    x = x + _mha(m.attn, x, m.norm_context(context), num_heads)
    return x + L.mlp(m.mlp, m.norm2(x))


class UpdateFormer(nn.Module):
    """``updateformer_init``'s tree: input and output norms, time blocks and
    the three space-block lists around ``virtual_tracks``."""

    def __init__(self, input_dim: int, hidden_size: int, output_dim: int,
                 space_depth: int = 6, time_depth: int = 6, num_virtual: int = 64,
                 device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.input_norm = L.LayerNorm(input_dim, **fk)
        self.input_transform = L.Linear(input_dim, hidden_size, **fk)
        self.output_norm = L.LayerNorm(hidden_size, **fk)
        self.flow_head = L.Linear(hidden_size, output_dim, **fk)
        self.virtual_tracks = nn.Parameter(torch.zeros((1, num_virtual, 1, hidden_size), **fk))
        self.time_blocks = nn.ModuleList(
            _attn_block_module(hidden_size, **fk) for _ in range(time_depth))
        self.space_virtual_blocks = nn.ModuleList(
            _attn_block_module(hidden_size, **fk) for _ in range(space_depth))
        self.space_point2virtual_blocks = nn.ModuleList(
            _cross_block_module(hidden_size, **fk) for _ in range(space_depth))
        self.space_virtual2point_blocks = nn.ModuleList(
            _cross_block_module(hidden_size, **fk) for _ in range(space_depth))


def _space_step(m: nn.Module, j: int, tokens: torch.Tensor, num_virtual: int, num_heads: int,
                attn_block, cross_block) -> torch.Tensor:
    """Points -> virtual tracks -> points through space block ``j`` of an
    update former; tokens (B, N, T, Ch) with the virtual tracks last."""
    B, N, T, Ch = tokens.shape
    s_tok = tokens.transpose(1, 2).reshape(B * T, N, Ch)
    pts, vir = s_tok[:, :N - num_virtual], s_tok[:, N - num_virtual:]
    vir = cross_block(m.space_virtual2point_blocks[j], vir, pts, num_heads)
    vir = attn_block(m.space_virtual_blocks[j], vir, num_heads)
    pts = cross_block(m.space_point2virtual_blocks[j], pts, vir, num_heads)
    return torch.cat([pts, vir], dim=1).reshape(B, T, N, Ch).transpose(1, 2)


def updateformer_forward(m: UpdateFormer, x: torch.Tensor, num_heads: int = 8,
                         num_virtual: int = 64) -> torch.Tensor:
    """x (B, N, T, input_dim) -> (B, N, T, output_dim)."""
    tokens = m.input_transform(m.input_norm(x))
    init_tokens = tokens
    B, _, T, Ch = tokens.shape
    tokens = torch.cat([tokens, m.virtual_tracks.to(tokens.dtype).expand(B, num_virtual, T, Ch)],
                       dim=1)
    N = tokens.shape[1]
    n_time, n_space = len(m.time_blocks), len(m.space_virtual_blocks)
    stride = max(1, n_time // max(n_space, 1))
    j = 0
    for i in range(n_time):
        tokens = _attn_block(m.time_blocks[i], tokens.reshape(B * N, T, Ch),
                             num_heads).reshape(B, N, T, Ch)
        if n_space and i % stride == 0 and j < n_space:
            tokens = _space_step(m, j, tokens, num_virtual, num_heads, _attn_block, _cross_block)
            j += 1
    tokens = tokens[:, :N - num_virtual] + init_tokens
    return m.flow_head(m.output_norm(tokens))


# ---------------------------------------------------------------------------
# Tracker and head
# ---------------------------------------------------------------------------

class Tracker(nn.Module):
    """``tracker_init``'s tree (the reference's ``BaseTrackerPredictor``)."""

    def __init__(self, latent_dim: int = 128, hidden_size: int = 384, corr_levels: int = 7,
                 corr_radius: int = 4, depth: int = 6, device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        tdim = 3 * latent_dim + 4
        self.corr_mlp = mlp_module(corr_levels * (2 * corr_radius + 1) ** 2, hidden_size,
                                   latent_dim, **fk)
        self.query_ref_token = nn.Parameter(torch.zeros((1, 2, tdim), **fk))
        self.updateformer = UpdateFormer(tdim, hidden_size, latent_dim + 2, space_depth=depth,
                                         time_depth=depth, **fk)
        self.fmap_norm = L.LayerNorm(latent_dim, **fk)
        self.ffeat_norm = L.LayerNorm(latent_dim, **fk)  # GroupNorm(1) == LN over C
        self.ffeat_updater = L.Linear(latent_dim, latent_dim, **fk)
        self.vis_predictor = L.Linear(latent_dim, 1, **fk)
        self.conf_predictor = L.Linear(latent_dim, 1, **fk)


def tracker_forward(m: Tracker, query_points: torch.Tensor, fmaps: torch.Tensor,
                    iters: int = 6, stride: int = 2, corr_levels: int = 7,
                    corr_radius: int = 4, max_scale: float = 518.0, latent_dim: int = 128,
                    down_ratio: int = 1):
    """query_points (B, N, 2) full-resolution pixels; fmaps (B, S, C, HH, WW).
    Returns (coord_preds: one (B, S, N, 2) a iteration, vis (B, S, N),
    conf (B, S, N))."""
    B, N, _ = query_points.shape
    _, S, C, HH, WW = fmaps.shape
    fmaps = m.fmap_norm(fmaps.permute(0, 1, 3, 4, 2)).permute(0, 1, 4, 2, 3)

    qp = query_points / float(down_ratio) / float(stride)
    coords = qp[:, None].expand(B, S, N, 2)
    query_feat = sample_features4d(fmaps[:, 0], coords[:, 0])  # (B, N, C)
    track_feats = query_feat[:, None].expand(B, S, N, latent_dim)
    coords0 = coords
    pos_map = get_2d_sincos_pos_embed(3 * latent_dim + 4, (HH, WW), device=fmaps.device)
    sampled_pos = sample_features4d(pos_map.expand(B, *pos_map.shape[1:]), coords[:, 0])
    qr = torch.cat([m.query_ref_token[:, 0:1],
                    m.query_ref_token[:, 1:2].expand(1, S - 1, m.query_ref_token.shape[-1])],
                   dim=1)

    coord_preds: List[torch.Tensor] = []
    for _ in range(iters):
        coords = coords.detach()
        fcorrs = corr_pyramid_sample(fmaps, track_feats, coords, corr_levels, corr_radius)
        corr_emb = m.corr_mlp.fc2(L.gelu_tanh(m.corr_mlp.fc1(
            fcorrs.transpose(1, 2).reshape(B * N, S, -1))))
        flows = (coords - coords[:, 0:1]).transpose(1, 2).reshape(B * N, S, 2)
        flows_emb = torch.cat([get_2d_embedding(flows, latent_dim // 2, cat_coords=False),
                               flows / max_scale, flows / max_scale], dim=-1)
        tf = track_feats.transpose(1, 2).reshape(B * N, S, latent_dim)
        x = torch.cat([flows_emb, corr_emb, tf], dim=-1)
        x = x + sampled_pos.reshape(B * N, 1, -1)
        x = (x + qr).reshape(B, N, S, -1)

        delta = updateformer_forward(m.updateformer, x).reshape(B * N, S, -1)
        d_coords = delta[:, :, :2]
        d_feats = delta[:, :, 2:].reshape(B * N * S, latent_dim)
        upd = L.gelu_tanh(m.ffeat_updater(m.ffeat_norm(d_feats)))
        tf_flat = upd + tf.reshape(B * N * S, latent_dim)
        track_feats = tf_flat.reshape(B, N, S, latent_dim).transpose(1, 2)

        coords = coords + d_coords.reshape(B, N, S, 2).transpose(1, 2)
        coords = torch.cat([coords0[:, :1], coords[:, 1:]], dim=1)
        coord_preds.append(coords * stride * down_ratio)

    feats_flat = track_feats.reshape(B * S * N, latent_dim)
    vis = torch.sigmoid(m.vis_predictor(feats_flat).reshape(B, S, N))
    conf = torch.sigmoid(m.conf_predictor(feats_flat).reshape(B, S, N))
    return coord_preds, vis, conf


class TrackHead(nn.Module):
    """``track_head_init``'s tree: the feature-only DPT at width ``features``
    and the tracker (its widths the reference's unless given)."""

    def __init__(self, cfg: VGGTConfig, features: int = 128, hidden_size: int = 384,
                 corr_levels: int = 7, corr_radius: int = 4, depth: int = 6,
                 device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.feature_extractor = DPTHead(cfg, output_dim=0, features=features,
                                         feature_only=True, **fk)
        self.tracker = Tracker(latent_dim=features, hidden_size=hidden_size,
                               corr_levels=corr_levels, corr_radius=corr_radius, depth=depth,
                               **fk)


def track_head_forward(head: TrackHead, layer_outputs: torch.Tensor, images_hw,
                       query_points: torch.Tensor, cfg: VGGTConfig, iters: int = 4,
                       corr_levels: int = 7, corr_radius: int = 4):
    """Returns (coord_preds list of (B, S, N, 2), vis (B, S, N), conf). The
    features are f32 at half the image's resolution; corr_levels and
    corr_radius must match the tracker's pyramid."""
    fmaps = dpt_head_forward(head.feature_extractor, layer_outputs, cfg, images_hw,
                             use_pos_embed=False, down_ratio=2)
    return tracker_forward(head.tracker, query_points, fmaps, iters=iters,
                           latent_dim=fmaps.shape[2], corr_levels=corr_levels,
                           corr_radius=corr_radius)


@torch.no_grad()
def random_init_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """The JAX initialisers' draws for a tracker tree (different numbers):
    kaiming-uniform linears and convs, layer norms ones/zeros, and the
    virtual tracks and query tokens N(0, 1)."""
    L.kaiming_uniform_init_(module, generator)
    for name, p in module.named_parameters():
        if name.rpartition(".")[2] in _NORMAL_LEAVES:
            p.normal_(0.0, 1.0, generator=generator)
    return module


def _build(module_cls, generator, device, dtype, *args, **kw) -> nn.Module:
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    module = module_cls(*args, device="meta", dtype=dtype, **kw).to_empty(device=device)
    return random_init_(module, generator)


def updateformer_init(input_dim: int, hidden_size: int, output_dim: int, space_depth: int = 6,
                      time_depth: int = 6, num_virtual: int = 64,
                      generator: Optional[torch.Generator] = None, device=None,
                      dtype: torch.dtype = torch.float32) -> UpdateFormer:
    """A random ``UpdateFormer`` on ``device`` (the card unless ``"cpu"``);
    ``generator`` lives there and defaults to one seeded with 0."""
    return _build(UpdateFormer, generator, device, dtype, input_dim, hidden_size, output_dim,
                  space_depth=space_depth, time_depth=time_depth, num_virtual=num_virtual)


def tracker_init(latent_dim: int = 128, hidden_size: int = 384, corr_levels: int = 7,
                 corr_radius: int = 4, depth: int = 6,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype: torch.dtype = torch.float32) -> Tracker:
    """A random ``Tracker`` (``updateformer_init``'s conventions)."""
    return _build(Tracker, generator, device, dtype, latent_dim=latent_dim,
                  hidden_size=hidden_size, corr_levels=corr_levels, corr_radius=corr_radius,
                  depth=depth)


def track_head_init(cfg: VGGTConfig, features: int = 128,
                    generator: Optional[torch.Generator] = None, device=None,
                    dtype: torch.dtype = torch.float32, **tracker_widths) -> TrackHead:
    """A random ``TrackHead`` (``updateformer_init``'s conventions)."""
    return _build(TrackHead, generator, device, dtype, cfg, features=features,
                  **tracker_widths)

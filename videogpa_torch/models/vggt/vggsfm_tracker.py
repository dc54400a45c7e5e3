"""The VGGSfM coarse-to-fine point tracker
(``videogpa_tpu/models/vggt/vggsfm_tracker.py``), the tracker of the
reference's ``track_predict.py`` (its ``vggsfm_v2_tracker.pt`` checkpoint
loads through :func:`convert_vggsfm_tracker`).

A coarse stage runs a ``BasicEncoder`` CNN at stride 4 on 2x-downsampled
images, then 6 iterations of correlation-pyramid sampling and an update
former (time attention along each track, space attention through 64
virtual tracks) predicting coordinate and feature deltas. A fine stage crops
a 31x31 patch around each coarse track, runs a ``ShallowEncoder`` on every
patch and a small tracker without space attention inside the patches.

The attention is plain PyTorch, as it is XLA code in the JAX package. Kept
as the reference has them, for its checkpoints:

- the blocks reassign the residual to the normed input, with non-affine
  layer norms of eps 1e-6 (the VGGT track head's are affine, eps 1e-5); the
  cross blocks' context norm is affine, eps 1e-5;
- the feature updater's GELU is the exact one;
- the fine tracker pads its token width by 4 (even) or 5 (odd) channels,
  the coarse one up to a multiple of 4;
- the checkpoint names the virtual tracks ``virual_tracks``;
- the patch's top-left corner is clamped with the image height on both
  axes (square images).

The crop is one advanced-index gather of (B·S, N, 3, P, P), not an
``unfold`` of every window.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from videogpa_torch.models.vggt.track import (
    _build, _mha, _space_step, corr_pyramid_sample, get_2d_embedding,
    get_2d_sincos_pos_embed, mha_module, mlp_module, sample_features4d)
from videogpa_torch.ops import layers as L
from videogpa_torch.ops.resize import resize_bilinear


# ---------------------------------------------------------------------------
# CNN encoders
# ---------------------------------------------------------------------------

def _instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``nn.InstanceNorm2d``'s default: per sample and channel over (H, W),
    no affine, biased variance, statistics in f32."""
    xf = x.float()
    mean = xf.mean(dim=(-2, -1), keepdim=True)
    var = xf.var(dim=(-2, -1), keepdim=True, correction=0)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def _residual_block_module(in_planes: int, planes: int, stride: int = 1, **fk) -> nn.Module:
    m = L.group(conv1=L.Conv2d(in_planes, planes, 3, stride=stride, padding=1, **fk),
                conv2=L.Conv2d(planes, planes, 3, padding=1, **fk))
    if stride != 1:
        m.add_module("downsample", L.Conv2d(in_planes, planes, 1, stride=stride, **fk))
    return m


def _residual_block(m: nn.Module, x: torch.Tensor) -> torch.Tensor:
    y = torch.relu(_instance_norm(m.conv1(x)))
    y = torch.relu(_instance_norm(m.conv2(y)))
    if hasattr(m, "downsample"):
        x = _instance_norm(m.downsample(x))
    return torch.relu(x + y)


class BasicEncoder(nn.Module):
    """``basic_encoder_init``'s tree (the reference's ``BasicEncoder``; the
    output stride is a forward-time argument)."""

    def __init__(self, input_dim: int = 3, output_dim: int = 128, device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        half = output_dim // 2
        dims = [half, output_dim // 4 * 3, output_dim, output_dim]
        self.conv1 = L.Conv2d(input_dim, half, 7, stride=2, padding=3, **fk)
        in_planes = half
        for li, dim in enumerate(dims, start=1):
            stride = 1 if li == 1 else 2
            setattr(self, f"layer{li}", nn.ModuleList([
                _residual_block_module(in_planes, dim, stride, **fk),
                _residual_block_module(dim, dim, 1, **fk)]))
            in_planes = dim
        self.conv2 = L.Conv2d(sum(dims), output_dim * 2, 3, padding=1, **fk)
        self.conv3 = L.Conv2d(output_dim * 2, output_dim, 1, **fk)


def basic_encoder_forward(m: BasicEncoder, x: torch.Tensor, stride: int = 4) -> torch.Tensor:
    """x (B, 3, H, W) -> (B, output_dim, H // stride, W // stride)."""
    H, W = x.shape[-2:]
    x = torch.relu(_instance_norm(m.conv1(x)))
    outs = []
    for li in range(1, 5):
        for block in getattr(m, f"layer{li}"):
            x = _residual_block(block, x)
        outs.append(resize_bilinear(x, (H // stride, W // stride), align_corners=True))
    x = torch.relu(_instance_norm(m.conv2(torch.cat(outs, dim=1))))
    return m.conv3(x)


class ShallowEncoder(nn.Module):
    """``shallow_encoder_init``'s tree (the reference's ``ShallowEncoder``)."""

    def __init__(self, input_dim: int = 3, output_dim: int = 32, device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.conv1 = L.Conv2d(input_dim, output_dim, 3, stride=2, padding=1, **fk)
        self.layer1 = _residual_block_module(output_dim, output_dim, 2, **fk)
        self.layer2 = _residual_block_module(output_dim, output_dim, 2, **fk)
        self.conv2 = L.Conv2d(output_dim, output_dim, 1, **fk)


def shallow_encoder_forward(m: ShallowEncoder, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x (B, 3, H, W) -> (B, output_dim, H // stride, W // stride)."""
    H, W = x.shape[-2:]
    x = torch.relu(_instance_norm(m.conv1(x)))
    hw = x.shape[-2:]
    tmp = _residual_block(m.layer1, x)
    x = x + resize_bilinear(tmp, hw, align_corners=True)
    tmp = _residual_block(m.layer2, tmp)
    x = x + resize_bilinear(tmp, hw, align_corners=True)
    x = m.conv2(x) + x
    return resize_bilinear(x, (H // stride, W // stride), align_corners=True)


# ---------------------------------------------------------------------------
# The VGGSfM update former
# ---------------------------------------------------------------------------

def _norm_na(x: torch.Tensor) -> torch.Tensor:
    return L.layernorm(x, eps=1e-6)


def _sfm_attn_block_module(dim: int, **fk) -> nn.Module:
    return L.group(attn=mha_module(dim, **fk), mlp=mlp_module(dim, dim * 4, **fk))


def _sfm_attn_block(m: nn.Module, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    x = _norm_na(x)  # the residual branches off the normed input
    x = x + _mha(m.attn, x, x, num_heads)
    return x + L.mlp(m.mlp, _norm_na(x))


def _sfm_cross_block_module(dim: int, **fk) -> nn.Module:
    m = _sfm_attn_block_module(dim, **fk)
    m.add_module("norm_context", L.LayerNorm(dim, **fk))
    return m


def _sfm_cross_block(m: nn.Module, x: torch.Tensor, context: torch.Tensor,
                     num_heads: int) -> torch.Tensor:
    x = _norm_na(x)
    x = x + _mha(m.attn, x, m.norm_context(context), num_heads)
    return x + L.mlp(m.mlp, _norm_na(x))


class SfMUpdateFormer(nn.Module):
    """``sfm_updateformer_init``'s tree: no input or output norm; the
    virtual tracks and space blocks only with ``space_depth``."""

    def __init__(self, input_dim: int, hidden_size: int, output_dim: int,
                 space_depth: int = 6, time_depth: int = 6, num_virtual: int = 64,
                 device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.input_transform = L.Linear(input_dim, hidden_size, **fk)
        self.flow_head = L.Linear(hidden_size, output_dim, **fk)
        self.time_blocks = nn.ModuleList(
            _sfm_attn_block_module(hidden_size, **fk) for _ in range(time_depth))
        if space_depth:
            self.virtual_tracks = nn.Parameter(
                torch.zeros((1, num_virtual, 1, hidden_size), **fk))
            self.space_virtual_blocks = nn.ModuleList(
                _sfm_attn_block_module(hidden_size, **fk) for _ in range(space_depth))
            self.space_point2virtual_blocks = nn.ModuleList(
                _sfm_cross_block_module(hidden_size, **fk) for _ in range(space_depth))
            self.space_virtual2point_blocks = nn.ModuleList(
                _sfm_cross_block_module(hidden_size, **fk) for _ in range(space_depth))


def sfm_updateformer_forward(m: SfMUpdateFormer, x: torch.Tensor, num_heads: int = 8,
                             num_virtual: int = 64) -> torch.Tensor:
    """x (B, N, T, input_dim) -> (B, N, T, output_dim)."""
    tokens = m.input_transform(x)
    init_tokens = tokens
    B, _, T, Ch = tokens.shape
    space = hasattr(m, "virtual_tracks")
    if space:
        tokens = torch.cat(
            [tokens, m.virtual_tracks.to(tokens.dtype).expand(B, num_virtual, T, Ch)], dim=1)
    N = tokens.shape[1]
    n_time = len(m.time_blocks)
    j = 0
    for i in range(n_time):
        tokens = _sfm_attn_block(m.time_blocks[i], tokens.reshape(B * N, T, Ch),
                                 num_heads).reshape(B, N, T, Ch)
        if space and i % (n_time // len(m.space_virtual_blocks)) == 0:
            tokens = _space_step(m, j, tokens, num_virtual, num_heads, _sfm_attn_block,
                                 _sfm_cross_block)
            j += 1
    if space:
        tokens = tokens[:, :N - num_virtual]
    return m.flow_head(tokens + init_tokens)


# ---------------------------------------------------------------------------
# The base tracker predictor
# ---------------------------------------------------------------------------

def transformer_dim_for(corr_levels: int, corr_radius: int, latent_dim: int, fine: bool) -> int:
    dim = corr_levels * (corr_radius * 2 + 1) ** 2 + latent_dim * 2
    if fine:
        return dim + (4 if dim % 2 == 0 else 5)
    return dim + (4 - dim % 4) % 4


class BaseTracker(nn.Module):
    """``base_tracker_init``'s tree; ``stride`` only sets the forward's."""

    def __init__(self, stride: int = 4, corr_levels: int = 5, corr_radius: int = 4,
                 latent_dim: int = 128, hidden_size: int = 384, use_spaceatt: bool = True,
                 depth: int = 6, fine: bool = False, device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        tdim = transformer_dim_for(corr_levels, corr_radius, latent_dim, fine)
        self.updateformer = SfMUpdateFormer(tdim, hidden_size, latent_dim + 2,
                                            space_depth=depth if use_spaceatt else 0,
                                            time_depth=depth, **fk)
        self.norm = L.LayerNorm(latent_dim, **fk)  # GroupNorm(1, C) == LN
        self.ffeat_updater = L.Linear(latent_dim, latent_dim, **fk)
        if not fine:
            self.vis_predictor = L.Linear(latent_dim, 1, **fk)


def base_tracker_forward(m: BaseTracker, query_points: torch.Tensor, fmaps: torch.Tensor,
                         iters: int = 4, stride: int = 4, corr_levels: int = 5,
                         corr_radius: int = 4, latent_dim: int = 128, fine: bool = False,
                         down_ratio: int = 1, return_feat: bool = False):
    """query_points (B, N, 2) image-scale xy; fmaps (B, S, C, HH, WW).
    Returns (coord_preds list, vis or None[, track_feats, query_feat])."""
    B, N, _ = query_points.shape
    _, S, C, HH, WW = fmaps.shape
    tdim = transformer_dim_for(corr_levels, corr_radius, latent_dim, fine)

    qp = query_points / float(down_ratio) / float(stride)
    coords = qp[:, None].expand(B, S, N, 2)
    query_feat = sample_features4d(fmaps[:, 0], coords[:, 0])  # (B, N, C)
    track_feats = query_feat[:, None].expand(B, S, N, latent_dim)
    coords0 = coords
    pos_map = get_2d_sincos_pos_embed(tdim, (HH, WW), device=fmaps.device)
    sampled_pos = sample_features4d(pos_map.expand(B, *pos_map.shape[1:]),
                                    coords[:, 0]).reshape(B * N, 1, tdim)

    coord_preds: List[torch.Tensor] = []
    for _ in range(iters):  # JAX's lax.scan over identical weights
        coords = coords.detach()
        fcorrs = corr_pyramid_sample(fmaps, track_feats, coords, corr_levels, corr_radius)
        fcorrs_ = fcorrs.transpose(1, 2).reshape(B * N, S, -1)
        flows = (coords - coords[:, 0:1]).transpose(1, 2).reshape(B * N, S, 2)
        flows_emb = torch.cat([get_2d_embedding(flows, latent_dim // 2, cat_coords=False),
                               flows], dim=-1)
        tf = track_feats.transpose(1, 2).reshape(B * N, S, latent_dim)
        x = torch.cat([flows_emb, fcorrs_, tf], dim=-1)
        pad = tdim - x.shape[-1]
        if pad:
            x = torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)
        x = (x + sampled_pos).reshape(B, N, S, tdim)

        delta = sfm_updateformer_forward(m.updateformer, x).reshape(B * N, S, latent_dim + 2)
        d_coords = delta[:, :, :2]
        d_feats = delta[:, :, 2:].reshape(B * N * S, latent_dim)
        upd = L.gelu(m.ffeat_updater(m.norm(d_feats)))
        tf_flat = upd + tf.reshape(B * N * S, latent_dim)
        track_feats = tf_flat.reshape(B, N, S, latent_dim).transpose(1, 2)

        coords = coords + d_coords.reshape(B, N, S, 2).transpose(1, 2)
        coords = torch.cat([coords0[:, :1], coords[:, 1:]], dim=1)
        coord_preds.append(coords * stride * down_ratio)

    vis = None
    if not fine:
        vis = torch.sigmoid(m.vis_predictor(
            track_feats.reshape(B * S * N, latent_dim)).reshape(B, S, N))
    if return_feat:
        return coord_preds, vis, track_feats, query_feat
    return coord_preds, vis


# ---------------------------------------------------------------------------
# Fine refinement
# ---------------------------------------------------------------------------

def extract_patches(images: torch.Tensor, topleft: torch.Tensor, psize: int) -> torch.Tensor:
    """images (BS, 3, H, W); topleft (BS, N, 2) integer xy -> (BS, N, 3, P, P),
    one gather."""
    BS = images.shape[0]
    ar = torch.arange(psize, device=images.device)
    yy = topleft[..., 1][..., None] + ar  # (BS, N, P)
    xx = topleft[..., 0][..., None] + ar
    b = torch.arange(BS, device=images.device)[:, None, None, None]
    patches = images.permute(0, 2, 3, 1)[b, yy[:, :, :, None], xx[:, :, None, :]]
    return patches.permute(0, 1, 4, 2, 3)  # (BS, N, P, P, 3) -> channels second


def refine_track(images: torch.Tensor, fine_fnet: ShallowEncoder, fine_tracker: BaseTracker,
                 coarse_pred: torch.Tensor, pradius: int = 15,
                 fine_iters: int = 6) -> torch.Tensor:
    """images (B, S, 3, H, W) in [0, 1]; coarse_pred (B, S, N, 2) -> refined
    tracks (B, S, N, 2). The reference's score branch (unused upstream) is
    left out, as in the JAX package."""
    B, S, N, _ = coarse_pred.shape
    H, W = images.shape[-2:]
    psize = pradius * 2 + 1

    query_points = coarse_pred[:, 0]
    track_int = torch.floor(coarse_pred).to(torch.int32)
    track_frac = coarse_pred - track_int.to(coarse_pred.dtype)
    topleft_bsn = track_int - pradius
    # the reference clamps both axes with H (square images)
    topleft = topleft_bsn.clamp(0, H - psize).reshape(B * S, N, 2).long()

    patches = extract_patches(images.reshape(B * S, 3, H, W), topleft, psize)
    patch_feat = shallow_encoder_forward(fine_fnet, patches.reshape(B * S * N, 3, psize, psize),
                                         stride=1)
    C_out = patch_feat.shape[1]
    patch_feat = patch_feat.reshape(B, S, N, C_out, psize, psize).transpose(1, 2).reshape(
        B * N, S, C_out, psize, psize)

    patch_query = (track_frac[:, 0] + pradius).reshape(B * N, 1, 2)
    preds, _ = base_tracker_forward(fine_tracker, patch_query, patch_feat, iters=fine_iters,
                                    stride=1, corr_levels=3, corr_radius=3, latent_dim=C_out,
                                    fine=True)
    fine_level = preds[-1].reshape(B, N, S, 2).transpose(1, 2)
    refined = fine_level + topleft_bsn.to(fine_level.dtype)
    return torch.cat([query_points[:, None], refined[:, 1:]], dim=1)


# ---------------------------------------------------------------------------
# The whole tracker
# ---------------------------------------------------------------------------

class VGGSfMTracker(nn.Module):
    """``vggsfm_tracker_init``'s tree at the published widths (the
    reference's ``TrackerPredictor``)."""

    def __init__(self, device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.coarse_fnet = BasicEncoder(**fk)
        self.coarse_predictor = BaseTracker(**fk)
        self.fine_fnet = ShallowEncoder(**fk)
        self.fine_predictor = BaseTracker(stride=1, depth=4, corr_levels=3, corr_radius=3,
                                          latent_dim=32, hidden_size=256, fine=True,
                                          use_spaceatt=False, **fk)


def process_images_to_fmaps(m: VGGSfMTracker, images: torch.Tensor) -> torch.Tensor:
    """(S, 3, H, W) -> coarse feature maps (S, 128, H // 8, W // 8): the
    images halved first (bilinear, align corners, no antialias)."""
    H, W = images.shape[-2:]
    down = resize_bilinear(images, (H // 2, W // 2), align_corners=True)
    return basic_encoder_forward(m.coarse_fnet, down, stride=4)


def vggsfm_tracker_forward(
    m: VGGSfMTracker, images: torch.Tensor, query_points: torch.Tensor,
    fmaps: Optional[torch.Tensor] = None, coarse_iters: int = 6,
    fine_tracking: bool = True, fine_pradius: int = 15,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """images (B, S, 3, H, W) in [0, 1]; query_points (B, N, 2) xy pixels.
    Returns (fine_pred_track, coarse_pred_track, pred_vis, pred_score):
    pred_score is None with fine tracking, else all ones."""
    B, S, _, H, W = images.shape
    if fmaps is None:
        fm = process_images_to_fmaps(m, images.reshape(B * S, 3, H, W))
        fmaps = fm.reshape(B, S, *fm.shape[1:])
    coarse_preds, pred_vis = base_tracker_forward(
        m.coarse_predictor, query_points, fmaps, iters=coarse_iters, stride=4,
        corr_levels=5, corr_radius=4, latent_dim=128, down_ratio=2)
    coarse_pred_track = coarse_preds[-1]
    if fine_tracking:
        return (refine_track(images, m.fine_fnet, m.fine_predictor, coarse_pred_track,
                             pradius=fine_pradius),
                coarse_pred_track, pred_vis, None)
    return coarse_pred_track, coarse_pred_track, pred_vis, torch.ones_like(pred_vis)


def basic_encoder_init(input_dim: int = 3, output_dim: int = 128,
                       generator: Optional[torch.Generator] = None, device=None,
                       dtype: torch.dtype = torch.float32) -> BasicEncoder:
    """A random ``BasicEncoder`` on ``device`` (the card unless ``"cpu"``),
    drawn as the JAX initialisers draw (different numbers)."""
    return _build(BasicEncoder, generator, device, dtype, input_dim, output_dim)


def shallow_encoder_init(input_dim: int = 3, output_dim: int = 32,
                         generator: Optional[torch.Generator] = None, device=None,
                         dtype: torch.dtype = torch.float32) -> ShallowEncoder:
    return _build(ShallowEncoder, generator, device, dtype, input_dim, output_dim)


def sfm_updateformer_init(input_dim: int, hidden_size: int, output_dim: int,
                          space_depth: int = 6, time_depth: int = 6, num_virtual: int = 64,
                          generator: Optional[torch.Generator] = None, device=None,
                          dtype: torch.dtype = torch.float32) -> SfMUpdateFormer:
    return _build(SfMUpdateFormer, generator, device, dtype, input_dim, hidden_size,
                  output_dim, space_depth=space_depth, time_depth=time_depth,
                  num_virtual=num_virtual)


def base_tracker_init(generator: Optional[torch.Generator] = None, device=None,
                      dtype: torch.dtype = torch.float32, **widths) -> BaseTracker:
    """A random ``BaseTracker``; ``widths`` are ``BaseTracker``'s arguments."""
    return _build(BaseTracker, generator, device, dtype, **widths)


def vggsfm_tracker_init(generator: Optional[torch.Generator] = None, device=None,
                        dtype: torch.dtype = torch.float32) -> VGGSfMTracker:
    """A random tracker at the published widths on ``device`` (the card
    unless ``"cpu"``); ``generator`` lives there, seeded with 0 by default."""
    return _build(VGGSfMTracker, generator, device, dtype)


# ---------------------------------------------------------------------------
# Weight conversion from the reference's checkpoint layout
# ---------------------------------------------------------------------------

def _upstream_key(key: str) -> str:
    """A ``VGGSfMTracker`` state-dict key -> the checkpoint's."""
    module, _, leaf = key.rpartition(".")
    if leaf == "virtual_tracks":
        return f"{module}.virual_tracks"  # the reference's spelling
    if module.endswith(".attn.in_proj"):
        owner = module[: -len(".in_proj")]
        if "2virtual_blocks" in owner or "2point_blocks" in owner:
            owner = owner[: -len("attn")] + "cross_attn"
        return f"{owner}.in_proj_{leaf}"
    if module.endswith(".attn.out_proj") and ("2virtual_blocks" in module
                                             or "2point_blocks" in module):
        return key.replace(".attn.out_proj.", ".cross_attn.out_proj.")
    if module.endswith((".downsample", ".ffeat_updater", ".vis_predictor")):
        return f"{module}.0.{leaf}"
    return key


def convert_vggsfm_tracker(state_dict: Mapping) -> Dict[str, np.ndarray]:
    """The reference ``TrackerPredictor``'s state dict (tensors or arrays)
    -> ``VGGSfMTracker``'s state dict (numpy). Raises ``KeyError`` naming
    the first checkpoint key the tree needs and the dict lacks."""
    sd = {k: v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
          for k, v in state_dict.items()}
    return {key: sd[_upstream_key(key)] for key in VGGSfMTracker(device="meta").state_dict()}

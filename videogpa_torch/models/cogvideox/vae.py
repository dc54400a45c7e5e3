"""CogVideoX 3D-causal VAE in PyTorch (``videogpa_tpu/models/cogvideox/vae.py``).

Same architecture as diffusers' ``AutoencoderKLCogVideoX``:

- causal 3D convs: the temporal pad replicates the FIRST frame (k_t - 1
  times), the spatial pad is zero, so frame t only sees frames <= t;
- encoder: conv_in -> 4 down blocks (spatial stride 2 after blocks 0-2;
  temporal pair-average after blocks 0-1, first frame kept) -> mid block ->
  GroupNorm/SiLU -> conv_out (2 x latent channels: mean ‖ logvar);
- decoder: conv_in -> mid -> 4 up blocks (nearest 2x spatial upsample;
  temporal 2x repeat except the first frame), resnet norms are z-conditioned
  spatial norms -> conv_out;
- 49 pixel frames <-> 13 latent frames (compression (4, 8, 8), z = 16).

The module tree mirrors the JAX parameter tree name for name (``encoder.down.
{i}.resnets.{j}.conv1``, ``decoder.up.{i}.upsample.conv``, ...), so
``videogpa_torch.convert`` loads a JAX tree strictly. Convolutions are plain
PyTorch (cuDNN on the card) in NCDHW; a weight is cast to the activation's
dtype, so bf16 weights applied to f32 latents compute in f32, as in the JAX
package. Products accumulate in f32 and the bias joins in the convolution's
f32 epilogue before the cast (``ops.layers.conv2d``'s convention); f32
convolutions on the card run with TF32 off. Group norms take f32 statistics
with the population variance (``F.group_norm``, as ``jnp.var``).

The tiled decode and encode stitch overlapping spatial tiles with linear
ramps into an f32 accumulator and weight map on the device, one tile after
another (the JAX package's ``lax.scan``).
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from videogpa_torch.device import resolve_device
from videogpa_torch.models.cogvideox.config import CogVideoXConfig
from videogpa_torch.ops import layers as L


# ---------------------------------------------------------------------------
# Primitive ops
# ---------------------------------------------------------------------------

def causal_conv3d(conv: nn.Module, x: torch.Tensor, stride=1) -> torch.Tensor:
    """Causal 3D conv, NCDHW; ``conv.weight`` (O, I, kt, kh, kw). Temporal
    pad: the first frame replicated; spatial: zeros."""
    kt, kh, kw = conv.weight.shape[2:]
    if kt > 1:
        x = torch.cat([x[:, :, :1].expand(-1, -1, kt - 1, -1, -1), x], dim=2)
    with L._full_f32_conv(x):
        return F.conv3d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype), stride=stride,
                        padding=(0, (kh - 1) // 2, (kw - 1) // 2))


def groupnorm(norm: nn.Module, x: torch.Tensor, groups: int = 32,
              eps: float = 1e-6) -> torch.Tensor:
    """GroupNorm over (B, C, ...) with f32 statistics and the population
    variance; ``math.gcd(groups, C)`` groups (real configs have C % 32 == 0,
    tiny ones do not)."""
    g = math.gcd(groups, x.shape[1])
    return F.group_norm(x.float(), g, norm.weight.float(), norm.bias.float(),
                        eps).to(x.dtype)


def _resize_zq(zq: torch.Tensor, t: int, h: int, w: int) -> torch.Tensor:
    """Nearest-resize zq (B, C, T', H', W') to (B, C, t, h, w) by integer
    indices ``arange(n) * N0 // n``; the first frame separate when the
    temporal sizes differ (the 1 + 2k causal pattern)."""
    _, _, T0, H0, W0 = zq.shape

    def index(n, n0):
        return torch.arange(n, device=zq.device) * n0 // max(n, 1)

    if T0 != t:
        rest = zq[:, :, 1:].index_select(2, index(t - 1, T0 - 1))
        zq = torch.cat([zq[:, :, :1], rest], dim=2)
    return zq.index_select(3, index(h, H0)).index_select(4, index(w, W0))


def spatial_norm(p: nn.Module, f: torch.Tensor, zq: torch.Tensor) -> torch.Tensor:
    zq = _resize_zq(zq, *f.shape[2:])
    return groupnorm(p.norm, f) * causal_conv3d(p.conv_y, zq) + causal_conv3d(p.conv_b, zq)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _groupnorm(ch: int, **fk) -> nn.GroupNorm:
    # a parameter holder: ``groupnorm`` picks the group count itself
    return nn.GroupNorm(1, ch, **fk)


def _spatial_norm(f_ch: int, zq_ch: int, **fk) -> nn.Module:
    return L.group(norm=_groupnorm(f_ch, **fk), conv_y=nn.Conv3d(zq_ch, f_ch, 1, **fk),
                   conv_b=nn.Conv3d(zq_ch, f_ch, 1, **fk))


def _resnet_module(in_ch: int, out_ch: int, zq_ch: Optional[int], **fk) -> nn.Module:
    def norm(ch):
        return _groupnorm(ch, **fk) if zq_ch is None else _spatial_norm(ch, zq_ch, **fk)

    m = L.group(norm1=norm(in_ch), conv1=nn.Conv3d(in_ch, out_ch, 3, **fk),
                norm2=norm(out_ch), conv2=nn.Conv3d(out_ch, out_ch, 3, **fk))
    if in_ch != out_ch:
        m.conv_shortcut = nn.Conv3d(in_ch, out_ch, 1, **fk)
    return m


def _resnet(p: nn.Module, x: torch.Tensor, zq: Optional[torch.Tensor]) -> torch.Tensor:
    def norm(n, h):
        return groupnorm(n, h) if zq is None else spatial_norm(n, h, zq)

    h = F.silu(norm(p.norm1, x))
    h = causal_conv3d(p.conv1, h)
    h = F.silu(norm(p.norm2, h))
    h = causal_conv3d(p.conv2, h)
    if hasattr(p, "conv_shortcut"):
        x = causal_conv3d(p.conv_shortcut, x)
    return x + h


def _frames_as_batch(x: torch.Tensor) -> torch.Tensor:
    B, C, T, H, W = x.shape
    return x.transpose(1, 2).reshape(B * T, C, H, W)


def _batch_as_frames(y: torch.Tensor, B: int) -> torch.Tensor:
    BT, C, H, W = y.shape
    return y.reshape(B, BT // B, C, H, W).transpose(1, 2)


def _downsample(p: nn.Module, x: torch.Tensor, compress_time: bool) -> torch.Tensor:
    B, C, T, H, W = x.shape
    if compress_time:
        rest = x[:, :, 1:]
        rest = rest.reshape(B, C, rest.shape[2] // 2, 2, H, W).mean(dim=3)
        x = torch.cat([x[:, :, :1], rest], dim=2)
    # spatial: asymmetric (0, 1) pad, then a stride-2 VALID conv
    x2 = F.pad(_frames_as_batch(x), (0, 1, 0, 1))
    return _batch_as_frames(L.conv2d(x2, p.conv.weight, p.conv.bias, stride=2), B)


def _upsample(p: nn.Module, x: torch.Tensor, compress_time: bool) -> torch.Tensor:
    B = x.shape[0]
    if compress_time:
        x = torch.cat([x[:, :, :1], x[:, :, 1:].repeat_interleave(2, dim=2)], dim=2)
    x2 = _frames_as_batch(x).repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    return _batch_as_frames(L.conv2d(x2, p.conv.weight, p.conv.bias, padding=1), B)


# ---------------------------------------------------------------------------
# Encoder / Decoder
# ---------------------------------------------------------------------------

class CogVideoXVAE(nn.Module):
    """The VAE's parameters, named after the JAX tree (``vae_init``)."""

    def __init__(self, cfg: CogVideoXConfig, device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.cfg = cfg
        ch = cfg.vae_block_out_channels
        z = cfg.vae_latent_channels
        npb = cfg.vae_layers_per_block

        down, in_ch = [], ch[0]
        for i, out_ch in enumerate(ch):
            block = L.group(resnets=nn.ModuleList(
                _resnet_module(in_ch if j == 0 else out_ch, out_ch, None, **fk)
                for j in range(npb)))
            if i < len(ch) - 1:
                block.downsample = L.group(conv=nn.Conv2d(out_ch, out_ch, 3, **fk))
            down.append(block)
            in_ch = out_ch
        self.encoder = L.group(
            conv_in=nn.Conv3d(3, ch[0], 3, **fk), down=nn.ModuleList(down),
            mid=L.group(resnets=nn.ModuleList(
                _resnet_module(ch[-1], ch[-1], None, **fk) for _ in range(2))),
            norm_out=_groupnorm(ch[-1], **fk), conv_out=nn.Conv3d(ch[-1], 2 * z, 3, **fk))

        rch = ch[::-1]
        up, in_ch = [], rch[0]
        for i, out_ch in enumerate(rch):
            block = L.group(resnets=nn.ModuleList(
                _resnet_module(in_ch if j == 0 else out_ch, out_ch, z, **fk)
                for j in range(npb + 1)))
            if i < len(rch) - 1:
                block.upsample = L.group(conv=nn.Conv2d(out_ch, out_ch, 3, **fk))
            up.append(block)
            in_ch = out_ch
        self.decoder = L.group(
            conv_in=nn.Conv3d(z, rch[0], 3, **fk),
            mid=L.group(resnets=nn.ModuleList(
                _resnet_module(rch[0], rch[0], z, **fk) for _ in range(2))),
            up=nn.ModuleList(up), norm_out=_spatial_norm(rch[-1], z, **fk),
            conv_out=nn.Conv3d(rch[-1], 3, 3, **fk))


@torch.no_grad()
def vae_init(cfg: CogVideoXConfig, generator: Optional[torch.Generator] = None,
             device=None, dtype: torch.dtype = torch.float32) -> CogVideoXVAE:
    """Random VAE allocated straight on ``device`` in ``dtype``: every conv's
    weight and bias ~ U(+-1/sqrt(fan_in)) and group norms ones/zeros, the
    bounds of the JAX initialisers. ``generator`` must live on ``device``;
    the default is seeded with 0."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    model = CogVideoXVAE(cfg, device="meta", dtype=dtype).to_empty(device=device)
    L.kaiming_uniform_init_(model, generator)
    return model.requires_grad_(False)


def _t_levels(cfg: CogVideoXConfig) -> int:
    return int(math.log2(cfg.temporal_compression_ratio))


def vae_encode(vae: CogVideoXVAE, video: torch.Tensor, cfg: CogVideoXConfig,
               generator: Optional[torch.Generator] = None,
               noise: Optional[torch.Tensor] = None, sample: bool = True) -> torch.Tensor:
    """(B, 3, T, H, W) in [-1, 1] -> scaled latents (B, z, T', H/8, W/8).

    T must be 4k + 1. With ``sample`` the posterior is sampled with ``noise``
    (the shape of the mean) or a draw from ``generator`` in the mean's dtype;
    one of the two is required."""
    enc = vae.encoder
    h = causal_conv3d(enc.conv_in, video)
    for i, block in enumerate(enc.down):
        for rp in block.resnets:
            h = _resnet(rp, h, None)
        if hasattr(block, "downsample"):
            h = _downsample(block.downsample, h, compress_time=i < _t_levels(cfg))
    for rp in enc.mid.resnets:
        h = _resnet(rp, h, None)
    h = F.silu(groupnorm(enc.norm_out, h))
    mean, logvar = causal_conv3d(enc.conv_out, h).chunk(2, dim=1)
    if sample:
        if noise is None:
            if generator is None:
                raise ValueError("sampling the posterior needs noise or a generator")
            noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                                dtype=mean.dtype)
        std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
        mean = mean + std * noise.to(device=mean.device, dtype=mean.dtype)
    if cfg.vae_invert_scale_latents:
        return mean / cfg.vae_scaling_factor
    return mean * cfg.vae_scaling_factor


def vae_decode(vae: CogVideoXVAE, latents: torch.Tensor, cfg: CogVideoXConfig) -> torch.Tensor:
    """Scaled latents (B, z, T', H', W') -> video (B, 3, T, 8H', 8W') in [-1, 1]."""
    z = (latents * cfg.vae_scaling_factor if cfg.vae_invert_scale_latents
         else latents / cfg.vae_scaling_factor)
    dec = vae.decoder
    h = causal_conv3d(dec.conv_in, z)
    for rp in dec.mid.resnets:
        h = _resnet(rp, h, z)
    for i, block in enumerate(dec.up):
        for rp in block.resnets:
            h = _resnet(rp, h, z)
        if hasattr(block, "upsample"):
            # time upsamples at the DEEP up blocks (i < levels), mirroring the
            # encoder's shallow-block downsampling
            h = _upsample(block.upsample, h, compress_time=i < _t_levels(cfg))
    h = F.silu(spatial_norm(dec.norm_out, h, z))
    return causal_conv3d(dec.conv_out, h)


# ---------------------------------------------------------------------------
# Tiled encode/decode (the reference's enable_tiling: bounds peak activation
# memory by coding overlapping spatial tiles and linear-blending the seams)
# ---------------------------------------------------------------------------

def _tile_positions(size: int, tile: int, overlap: int) -> List[int]:
    """Uniform-size tile start positions, the last tile end-aligned."""
    if size <= tile:
        return [0]
    stride = max(tile - overlap, max(tile // 2, 1))  # overlap can't eat the tile
    pos = list(range(0, size - tile, stride))
    pos.append(size - tile)
    return pos


def _ramp_1d_np(n: int, first: bool, last: bool) -> np.ndarray:
    """Linear border ramp for weighted tile stitching (16-sample edges)."""
    w = np.ones(n, np.float32)
    edge = min(n // 2, 16)
    if not first:
        w[:edge] = np.linspace(0, 1, edge, endpoint=False)
    if not last:
        w[-edge:] = np.linspace(1, 0, edge, endpoint=False)
    return w


def _tile_grid(H, W, th, tw, overlap):
    pos_h = _tile_positions(H, th, overlap)
    pos_w = _tile_positions(W, tw, overlap)
    grid = [(hi, wi, i0, j0) for hi, i0 in enumerate(pos_h) for wi, j0 in enumerate(pos_w)]
    return pos_h, pos_w, grid


def _ramp_stacks(grid, n_h, n_w, th_out, tw_out):
    whs = np.stack([_ramp_1d_np(th_out, hi == 0, hi == n_h - 1) for hi, wi, _, _ in grid])
    wws = np.stack([_ramp_1d_np(tw_out, wi == 0, wi == n_w - 1) for hi, wi, _, _ in grid])
    return whs, wws


def _stitch(tile_fn, grid, whs, wws, out_shape, tile_out_hw, device) -> torch.Tensor:
    """Weighted accumulation of ``tile_fn(k, i0, j0)`` tiles, positions in
    output cells, into an f32 accumulator and weight map on ``device``."""
    th_out, tw_out = tile_out_hw
    acc = torch.zeros(out_shape, dtype=torch.float32, device=device)
    wacc = torch.zeros(out_shape[-2:], dtype=torch.float32, device=device)
    for k, (_, _, i0, j0) in enumerate(grid):
        wmap = torch.from_numpy(whs[k][:, None] * wws[k][None, :]).to(device)
        tile = tile_fn(k, i0, j0)
        acc[..., i0:i0 + th_out, j0:j0 + tw_out] += tile.float() * wmap
        wacc[i0:i0 + th_out, j0:j0 + tw_out] += wmap
        del tile
    return acc / torch.clamp(wacc, min=1e-8)


def vae_decode_tiled(vae: CogVideoXVAE, latents: torch.Tensor, cfg: CogVideoXConfig,
                     tile_latent: int = 32, overlap_latent: int = 8) -> torch.Tensor:
    """Spatially tiled decode: uniform latent tiles, linear-ramp weighted
    stitching in pixel space on the device; f32 out. A grid no larger than
    the tile decodes whole, in the latents' dtype."""
    B, C, T, H, W = latents.shape
    if H <= tile_latent and W <= tile_latent:
        return vae_decode(vae, latents, cfg)
    sc = cfg.spatial_compression_ratio
    th, tw = min(tile_latent, H), min(tile_latent, W)
    pos_h, pos_w, grid = _tile_grid(H, W, th, tw, overlap_latent)
    whs, wws = _ramp_stacks(grid, len(pos_h), len(pos_w), th * sc, tw * sc)
    T_out = (T - 1) * cfg.temporal_compression_ratio + 1
    scaled = [(hi, wi, i0 * sc, j0 * sc) for hi, wi, i0, j0 in grid]

    def tile_fn(k, oi, oj):
        li, lj = grid[k][2:]
        return vae_decode(vae, latents[:, :, :, li:li + th, lj:lj + tw], cfg)

    return _stitch(tile_fn, scaled, whs, wws, (B, 3, T_out, H * sc, W * sc),
                   (th * sc, tw * sc), latents.device)


def vae_encode_tiled(vae: CogVideoXVAE, video: torch.Tensor, cfg: CogVideoXConfig,
                     generator: Optional[torch.Generator] = None,
                     noise: Optional[Sequence[torch.Tensor]] = None, sample: bool = True,
                     tile_pixels: int = 256, overlap_pixels: int = 64) -> torch.Tensor:
    """Spatially tiled encode: uniform pixel tiles, weighted latent stitching
    on the device; f32 out. Each tile samples its own posterior noise, in
    grid order (rows of tiles, top to bottom): ``noise[k]`` for tile k, else
    a draw from ``generator``. A frame no larger than the tile encodes whole
    with ``noise[0]``."""
    B, C, T, H, W = video.shape
    if H <= tile_pixels and W <= tile_pixels:
        return vae_encode(vae, video, cfg, generator=generator,
                          noise=None if noise is None else noise[0], sample=sample)
    sc = cfg.spatial_compression_ratio
    th, tw = min(tile_pixels, H), min(tile_pixels, W)
    # positions must be /sc-aligned so latent tiles stitch on integer cells
    pos_h = sorted({p // sc for p in _tile_positions(H, th, overlap_pixels)})
    pos_w = sorted({p // sc for p in _tile_positions(W, tw, overlap_pixels)})
    grid = [(hi, wi, i0, j0) for hi, i0 in enumerate(pos_h) for wi, j0 in enumerate(pos_w)]
    if noise is not None and len(noise) != len(grid):
        raise ValueError(f"{len(noise)} noise tensors for {len(grid)} tiles")
    whs, wws = _ramp_stacks(grid, len(pos_h), len(pos_w), th // sc, tw // sc)
    T_lat = (T - 1) // cfg.temporal_compression_ratio + 1

    def tile_fn(k, i0, j0):
        v = video[:, :, :, i0 * sc:i0 * sc + th, j0 * sc:j0 * sc + tw]
        return vae_encode(vae, v, cfg, generator=generator,
                          noise=None if noise is None else noise[k], sample=sample)

    return _stitch(tile_fn, grid, whs, wws,
                   (B, cfg.vae_latent_channels, T_lat, H // sc, W // sc),
                   (th // sc, tw // sc), video.device)

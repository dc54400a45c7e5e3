"""Wan2.2 VAE in PyTorch (``videogpa_tpu/models/wan/vae.py``): z = 48,
compression (4, 16, 16).

The upstream ``Wan2_2_VAE`` (``wan/modules/vae2_2.py``):

- a 2 x 2 spatial patchify at the input and unpatchify at the output
  (``b c f (h q) (w r) -> b (c r q) f h w``);
- causal 3D convolutions: kt - 1 zero frames in front, so frame t sees
  frames <= t;
- encoder: conv_in -> 4 scales of [2 resnets + an optional stride-2
  downsample] with a parameter-free AvgDown3D shortcut (space and time to
  channels, then a grouped channel mean), temporal stride at scales 1-2;
- decoder (base 256 against the encoder's 160): 4 scales of [3 resnets +
  an optional upsample] with a DupUp3D shortcut (channel repeat, channels to
  space and time), temporal upsample at scales 0-1;
- RMS norms (L2 over the channels x sqrt(C) x gamma), single-head spatial
  attention per frame in the mid blocks, in f32 with ``torch.matmul`` and a
  softmax (D = 640 in the encoder, 1,024 in the decoder; it is no
  ``ops.attention`` call);
- T pixel frames <-> 1 + (T - 1) / 4 latent frames.

Two forms compute the same function:

- **streaming** (``stream=True``, the default; the upstream protocol): the
  encoder takes chunks of 1, 4, 4, ... pixel frames and the decoder one
  latent frame at a time. A ``_Stream`` carries, from one chunk to the
  next, the last kt - 1 input frames of every causal convolution (zeros
  before the first chunk), the last frame a temporal downsample saw, and
  whether the chunk is the first: on it the temporal downsample passes
  frame 0 through without convolving it, the temporal upsample lets frame 0
  bypass its time convolution (the upstream "Rep" slot), and DupUp3D trims
  its ft - 1 leading frames. Memory holds one chunk's activations, so
  81 frames at 704 x 1,280 fit on one card beside the DiT and umT5.
- **full sequence** (``stream=False``, the plain version): the same code on
  one chunk holding every frame, which is the JAX package's one-shot form.
  At 81f@704x1,280 one of its tensors is 37 GB: it is for small inputs.

Convolutions are plain PyTorch (cuDNN on the card) in NCDHW, in f32 with
TF32 off (``ops.layers._full_f32_conv``); the module tree mirrors the JAX
parameter tree name for name (``encoder.scales.{i}.resnets.{j}.conv1``,
``decoder.mid.attn.qkv``, ...), so ``videogpa_torch.convert`` loads a JAX
tree strictly and ``models.wan.convert.convert_wan_vae`` an upstream
checkpoint.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from videogpa_torch.device import resolve_device
from videogpa_torch.models.cogvideox.vae import _batch_as_frames, _frames_as_batch
from videogpa_torch.models.wan.config import WanConfig
from videogpa_torch.ops import layers as L


class _Stream:
    """What one time chunk hands the next: the frames each causal
    convolution and temporal downsample carries (keyed by its module), and
    whether the chunk now running is the first."""

    def __init__(self):
        self.frames: Dict[nn.Module, torch.Tensor] = {}
        self.first = True


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------

def _conv3d(conv: nn.Module, x: torch.Tensor, t_stride: int = 1) -> torch.Tensor:
    """NCDHW convolution with no temporal padding and symmetric zero spatial
    padding; ``conv.weight`` (O, I, kt, kh, kw)."""
    kh, kw = conv.weight.shape[3:]
    with L._full_f32_conv(x):
        return F.conv3d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype),
                        stride=(t_stride, 1, 1), padding=(0, (kh - 1) // 2, (kw - 1) // 2))


def _causal_conv3d(conv: nn.Module, x: torch.Tensor, stream: _Stream) -> torch.Tensor:
    """Causal 3D conv: the kt - 1 frames before the chunk (zeros before the
    first) are prepended, and the chunk's last kt - 1 frames carried on."""
    kt = conv.weight.shape[2]
    if kt > 1:
        prev = stream.frames.get(conv)
        if prev is None:
            prev = x.new_zeros(x.shape[:2] + (kt - 1,) + x.shape[3:])
        x = torch.cat([prev, x], dim=2)
        stream.frames[conv] = x[:, :, -(kt - 1):].clone()
    return _conv3d(conv, x)


def _conv2d_frames(conv: nn.Module, x: torch.Tensor, stride: int = 1,
                   padding="same") -> torch.Tensor:
    """2D conv applied per frame on (B, C, T, H, W), T folded into the batch;
    "same" pads (k - 1) // 2 on every side."""
    if padding == "same":
        padding = (conv.weight.shape[-1] - 1) // 2
    y = L.conv2d(_frames_as_batch(x), conv.weight, conv.bias, stride=stride, padding=padding)
    return _batch_as_frames(y, x.shape[0])


def _rms_norm(norm: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Wan RMS_norm: x / max(||x||_channels, 1e-12) * sqrt(C) * gamma, f32."""
    C = x.shape[1]
    xf = F.normalize(x.float(), dim=1, eps=1e-12) * math.sqrt(C)
    shape = (1, C) + (1,) * (x.dim() - 2)
    return (xf * norm.gamma.float().reshape(shape)).to(x.dtype)


class _RMSNorm(nn.Module):
    """Holder of ``_rms_norm``'s gamma (C,), the JAX tree's ``gamma`` leaf."""

    def __init__(self, ch: int, device=None, dtype=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(ch, device=device, dtype=dtype))


def _resnet_module(in_ch: int, out_ch: int, **fk) -> nn.Module:
    m = L.group(norm1=_RMSNorm(in_ch, **fk), conv1=nn.Conv3d(in_ch, out_ch, 3, **fk),
                norm2=_RMSNorm(out_ch, **fk), conv2=nn.Conv3d(out_ch, out_ch, 3, **fk))
    if in_ch != out_ch:
        m.shortcut = nn.Conv3d(in_ch, out_ch, 1, **fk)
    return m


def _resnet(p: nn.Module, x: torch.Tensor, stream: _Stream) -> torch.Tensor:
    h = F.silu(_rms_norm(p.norm1, x))
    h = _causal_conv3d(p.conv1, h, stream)
    h = F.silu(_rms_norm(p.norm2, h))
    h = _causal_conv3d(p.conv2, h, stream)
    return h + (_conv3d(p.shortcut, x) if hasattr(p, "shortcut") else x)


def _attn_block(p: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Single-head spatial self-attention per frame (Wan AttentionBlock):
    f32 logits and softmax, ``torch.matmul`` products."""
    B, C, T, H, W = x.shape
    qkv = _conv2d_frames(p.qkv, _rms_norm(p.norm, x))  # (B, 3C, T, H, W)
    q, k, v = qkv.reshape(B, 3, C, T, H * W).unbind(1)  # (B, C, T, HW)
    logits = torch.matmul(q.permute(0, 2, 3, 1).float(), k.transpose(1, 2).float())
    attn = torch.softmax(logits / math.sqrt(C), dim=-1).to(x.dtype)  # (B, T, HW, HW)
    o = torch.matmul(attn.float(), v.permute(0, 2, 3, 1).float())  # (B, T, HW, C)
    o = o.to(x.dtype).permute(0, 3, 1, 2).reshape(B, C, T, H, W)
    return _conv2d_frames(p.proj, o) + x


# ---------------------------------------------------------------------------
# Parameter-free shuffles
# ---------------------------------------------------------------------------

def _patchify(x: torch.Tensor, ps: int) -> torch.Tensor:
    """b c f (h q) (w r) -> b (c r q) f h w."""
    if ps == 1:
        return x
    B, C, T, H, W = x.shape
    x = x.reshape(B, C, T, H // ps, ps, W // ps, ps)  # b c f h q w r
    x = x.permute(0, 1, 6, 4, 2, 3, 5)  # b c r q f h w
    return x.reshape(B, C * ps * ps, T, H // ps, W // ps)


def _unpatchify(x: torch.Tensor, ps: int) -> torch.Tensor:
    if ps == 1:
        return x
    B, CP, T, H, W = x.shape
    C = CP // (ps * ps)
    x = x.reshape(B, C, ps, ps, T, H, W)  # b c r q f h w
    x = x.permute(0, 1, 4, 5, 3, 6, 2)  # b c f h q w r
    return x.reshape(B, C, T, H * ps, W * ps)


def _avg_down3d(x: torch.Tensor, out_ch: int, ft: int, fs: int) -> torch.Tensor:
    """Wan AvgDown3D: zero-pad time in front to a multiple of ft (only the
    first chunk of 1 frame, or a whole sequence of 1 + 2k, needs it),
    space-to-channel (packing order C, t_off, h_off, w_off), grouped channel
    mean to out_ch."""
    B, C, T, H, W = x.shape
    pad_t = (ft - T % ft) % ft
    if pad_t:
        x = F.pad(x, (0, 0, 0, 0, pad_t, 0))
        T += pad_t
    g = C * ft * fs * fs // out_ch
    x = x.reshape(B, C, T // ft, ft, H // fs, fs, W // fs, fs)
    x = x.permute(0, 1, 3, 5, 7, 2, 4, 6)  # B C ft fsh fsw T' H' W'
    x = x.reshape(B, out_ch, g, T // ft, H // fs, W // fs)
    return x.mean(dim=2)


def _dup_up3d(x: torch.Tensor, out_ch: int, ft: int, fs: int, first: bool) -> torch.Tensor:
    """Wan DupUp3D: channel repeat_interleave, channel-to-space (the inverse
    packing of AvgDown3D); the first chunk drops its ft - 1 leading frames."""
    B, C, T, H, W = x.shape
    x = x.repeat_interleave(out_ch * ft * fs * fs // C, dim=1)
    x = x.reshape(B, out_ch, ft, fs, fs, T, H, W)
    x = x.permute(0, 1, 5, 2, 6, 3, 7, 4)  # B C T ft H fsh W fsw
    x = x.reshape(B, out_ch, T * ft, H * fs, W * fs)
    return x[:, :, ft - 1:] if first else x


# ---------------------------------------------------------------------------
# Resample blocks
# ---------------------------------------------------------------------------

def _resample_down(p: nn.Module, x: torch.Tensor, temporal: bool, stream: _Stream) -> torch.Tensor:
    """downsample2d/3d: ZeroPad2d((0, 1, 0, 1)) + Conv2d k3 s2; then (3d) the
    stride-2 temporal conv over windows (x_{2n-2}, x_{2n-1}, x_{2n}), frame 0
    passing through. A later chunk starts its windows at the frame carried
    from the one before."""
    h = _conv2d_frames(p.conv, F.pad(x, (0, 1, 0, 1)), stride=2, padding=0)
    if not temporal:
        return h
    if stream.first:
        head, src = h[:, :, :1], h
    else:
        head, src = None, torch.cat([stream.frames[p.time_conv], h], dim=2)
    stream.frames[p.time_conv] = h[:, :, -1:].clone()
    parts = [head] if head is not None else []
    if src.shape[2] >= 3:
        parts.append(_conv3d(p.time_conv, src, t_stride=2))
    return torch.cat(parts, dim=2) if len(parts) > 1 else parts[0]


def _resample_up(p: nn.Module, x: torch.Tensor, temporal: bool, stream: _Stream) -> torch.Tensor:
    """upsample2d/3d: (3d) frames after frame 0 run a causal conv to 2C
    channels, split and interleaved into 2 frames each, while frame 0
    bypasses it; then nearest 2x and Conv2d k3."""
    if temporal:
        head, rest = (x[:, :, :1], x[:, :, 1:]) if stream.first else (None, x)
        parts = [head] if head is not None else []
        if rest.shape[2]:
            B, C, n, H, W = rest.shape
            h = _causal_conv3d(p.time_conv, rest, stream)  # (B, 2C, n, H, W)
            parts.append(h.reshape(B, 2, C, n, H, W).permute(0, 2, 3, 1, 4, 5)
                         .reshape(B, C, 2 * n, H, W))
        x = torch.cat(parts, dim=2) if len(parts) > 1 else parts[0]
    x = x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)  # nearest 2x
    return _conv2d_frames(p.conv, x)


# ---------------------------------------------------------------------------
# Module
# ---------------------------------------------------------------------------

def _enc_dims(cfg: WanConfig) -> List[int]:
    return [cfg.vae_base_ch * u for u in [1] + list(cfg.vae_dim_mult)]


def _dec_dims(cfg: WanConfig) -> List[int]:
    m = list(cfg.vae_dim_mult)
    return [cfg.vae_dec_base_ch * u for u in [m[-1]] + m[::-1]]


def _temporal(flags, i: int) -> bool:
    return flags[i] if i < len(flags) else False


def _mid_module(ch: int, **fk) -> nn.Module:
    attn = L.group(norm=_RMSNorm(ch, **fk), qkv=nn.Conv2d(ch, 3 * ch, 1, **fk),
                   proj=nn.Conv2d(ch, ch, 1, **fk))
    return L.group(res1=_resnet_module(ch, ch, **fk), attn=attn,
                   res2=_resnet_module(ch, ch, **fk))


def _resample_module(ch: int, time_out: Optional[int], **fk) -> nn.Module:
    m = L.group(conv=nn.Conv2d(ch, ch, 3, **fk))
    if time_out is not None:
        m.time_conv = nn.Conv3d(ch, time_out, (3, 1, 1), **fk)
    return m


class WanVAE(nn.Module):
    """The VAE's parameters, named after the JAX tree (``wan_vae_init``),
    with the latent statistics as buffers."""

    def __init__(self, cfg: WanConfig, device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.cfg = cfg
        z, ps, n = cfg.vae_z_dim, cfg.vae_patch_size, len(cfg.vae_dim_mult)
        t_down = list(cfg.vae_temporal_down)

        dims = _enc_dims(cfg)
        scales = []
        for i, (cin, cout) in enumerate(zip(dims[:-1], dims[1:])):
            s = L.group(resnets=nn.ModuleList(
                _resnet_module(cin if j == 0 else cout, cout, **fk)
                for j in range(cfg.vae_num_res_blocks)))
            if i != n - 1:
                s.resample = _resample_module(cout, cout if _temporal(t_down, i) else None, **fk)
            scales.append(s)
        self.encoder = L.group(
            conv_in=nn.Conv3d(3 * ps * ps, dims[0], 3, **fk), scales=nn.ModuleList(scales),
            mid=_mid_module(dims[-1], **fk), head_norm=_RMSNorm(dims[-1], **fk),
            conv_out=nn.Conv3d(dims[-1], 2 * z, 3, **fk))

        ddims, t_up = _dec_dims(cfg), t_down[::-1]
        scales = []
        for i, (cin, cout) in enumerate(zip(ddims[:-1], ddims[1:])):
            s = L.group(resnets=nn.ModuleList(
                _resnet_module(cin if j == 0 else cout, cout, **fk)
                for j in range(cfg.vae_num_res_blocks + 1)))
            if i != n - 1:
                s.resample = _resample_module(cout, 2 * cout if _temporal(t_up, i) else None,
                                              **fk)
            scales.append(s)
        self.decoder = L.group(
            conv_in=nn.Conv3d(z, ddims[0], 3, **fk), mid=_mid_module(ddims[0], **fk),
            scales=nn.ModuleList(scales), head_norm=_RMSNorm(ddims[-1], **fk),
            conv_out=nn.Conv3d(ddims[-1], 3 * ps * ps, 3, **fk))

        self.quant_conv = nn.Conv3d(2 * z, 2 * z, 1, **fk)
        self.post_quant_conv = nn.Conv3d(z, z, 1, **fk)
        self.register_buffer("latents_mean", torch.zeros(z, device=device, dtype=torch.float32))
        self.register_buffer("latents_std", torch.ones(z, device=device, dtype=torch.float32))


@torch.no_grad()
def wan_vae_init(cfg: WanConfig, generator: Optional[torch.Generator] = None, device=None,
                 dtype: torch.dtype = torch.float32) -> WanVAE:
    """Random VAE allocated straight on ``device`` in ``dtype``, with the JAX
    initialisers' distributions: every conv's weight and bias ~
    U(+-1/sqrt(fan_in)), gammas one, latent mean 0 and std 1. ``generator``
    must live on ``device``; the default is seeded with 0."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    model = WanVAE(cfg, device="meta", dtype=dtype).to_empty(device=device)
    L.kaiming_uniform_init_(model, generator)
    for m in model.modules():
        if isinstance(m, _RMSNorm):
            m.gamma.fill_(1.0)
    model.latents_mean.zero_()
    model.latents_std.fill_(1.0)
    return model.requires_grad_(False)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _mid(p: nn.Module, h: torch.Tensor, stream: _Stream) -> torch.Tensor:
    h = _resnet(p.res1, h, stream)
    h = _attn_block(p.attn, h)
    return _resnet(p.res2, h, stream)


def _encode_chunk(vae: WanVAE, x: torch.Tensor, cfg: WanConfig, stream: _Stream) -> torch.Tensor:
    """Patchified frames (B, 12, t, H/2, W/2) -> moments before quant_conv."""
    t_down, n = list(cfg.vae_temporal_down), len(cfg.vae_dim_mult)
    dims, enc = _enc_dims(cfg), vae.encoder
    h = _causal_conv3d(enc.conv_in, x, stream)
    for i, scale in enumerate(enc.scales):
        sc_in = h
        for rp in scale.resnets:
            h = _resnet(rp, h, stream)
        temporal = _temporal(t_down, i)
        if hasattr(scale, "resample"):
            h = _resample_down(scale.resample, h, temporal, stream)
        ft = 2 if (temporal and i != n - 1) else 1
        fs = 2 if i != n - 1 else 1
        h = h + _avg_down3d(sc_in, dims[i + 1], ft, fs)
    h = _mid(enc.mid, h, stream)
    h = F.silu(_rms_norm(enc.head_norm, h))
    return _causal_conv3d(enc.conv_out, h, stream)


def _decode_chunk(vae: WanVAE, z: torch.Tensor, cfg: WanConfig, stream: _Stream) -> torch.Tensor:
    """Latents after post_quant_conv (B, z, t, h, w) -> patchified pixels."""
    t_up = list(cfg.vae_temporal_down)[::-1]
    ddims, dec = _dec_dims(cfg), vae.decoder
    h = _causal_conv3d(dec.conv_in, z, stream)
    h = _mid(dec.mid, h, stream)
    for i, scale in enumerate(dec.scales):
        sc_in = h
        for rp in scale.resnets:
            h = _resnet(rp, h, stream)
        if hasattr(scale, "resample"):
            temporal = _temporal(t_up, i)
            h = _resample_up(scale.resample, h, temporal, stream)
            h = h + _dup_up3d(sc_in, ddims[i + 1], 2 if temporal else 1, 2, stream.first)
    h = F.silu(_rms_norm(dec.head_norm, h))
    return _causal_conv3d(dec.conv_out, h, stream)


def _stats(vae: WanVAE, like: torch.Tensor):
    shape = (1, -1, 1, 1, 1)
    return (vae.latents_mean.to(like.dtype).reshape(shape),
            vae.latents_std.to(like.dtype).reshape(shape))


@torch.no_grad()
def wan_vae_encode(vae: WanVAE, video: torch.Tensor, cfg: WanConfig,
                   generator: Optional[torch.Generator] = None,
                   noise: Optional[torch.Tensor] = None, sample: bool = False,
                   stream: bool = True) -> torch.Tensor:
    """(B, 3, T, H, W) in [-1, 1], T = 4k + 1 -> normalized latents
    (B, z, 1 + (T - 1) / 4, H / 16, W / 16), on the VAE's device.

    ``sample=False`` (the default) returns the posterior mean, as
    ``Wan2_2_VAE.encode`` does; with ``sample`` the posterior is sampled with
    ``noise`` (the mean's shape) or a draw from ``generator``. ``stream``
    encodes chunks of 1, 4, 4, ... frames (module docstring); False encodes
    the whole sequence in one chunk."""
    device = vae.latents_mean.device
    x = _patchify(video.to(device=device, dtype=torch.float32), cfg.vae_patch_size)
    T = x.shape[2]
    if (T - 1) % 4:
        raise ValueError(f"the Wan VAE encodes 4k + 1 frames, got {T}")
    bounds = [0] + list(range(1, T + 1, 4)) if stream else [0, T]
    state, moments = _Stream(), []
    for a, b in zip(bounds[:-1], bounds[1:]):
        moments.append(_encode_chunk(vae, x[:, :, a:b], cfg, state))
        state.first = False
    moments = _conv3d(vae.quant_conv, torch.cat(moments, dim=2))
    mean, logvar = moments.chunk(2, dim=1)
    if sample:
        if noise is None:
            if generator is None:
                raise ValueError("sampling the posterior needs noise or a generator")
            noise = torch.randn(mean.shape, generator=generator, device=device, dtype=mean.dtype)
        std = torch.exp(0.5 * torch.clamp(logvar, -30.0, 20.0))
        mean = mean + std * noise.to(device=device, dtype=mean.dtype)
    lm, ls = _stats(vae, mean)
    return (mean - lm) / ls


@torch.no_grad()
def wan_vae_decode(vae: WanVAE, latents: torch.Tensor, cfg: WanConfig,
                   stream: bool = True) -> torch.Tensor:
    """Normalized latents (B, z, T', H', W') -> video (B, 3, 1 + 4(T' - 1),
    16H', 16W') clamped to [-1, 1], f32 on the VAE's device. ``stream``
    decodes one latent frame at a time; False decodes them in one chunk."""
    device = vae.latents_mean.device
    latents = latents.to(device=device, dtype=torch.float32)
    lm, ls = _stats(vae, latents)
    z = _conv3d(vae.post_quant_conv, latents * ls + lm)
    T = z.shape[2]
    bounds = list(range(T + 1)) if stream else [0, T]
    state, frames = _Stream(), []
    for a, b in zip(bounds[:-1], bounds[1:]):
        frames.append(_unpatchify(_decode_chunk(vae, z[:, :, a:b], cfg, state),
                                  cfg.vae_patch_size).clamp_(-1.0, 1.0))
        state.first = False
    return torch.cat(frames, dim=2) if len(frames) > 1 else frames[0]

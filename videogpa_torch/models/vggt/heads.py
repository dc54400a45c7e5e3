"""VGGT's prediction heads (``videogpa_tpu/models/vggt/heads.py``): the
iterative camera head and the DPT dense heads.

The camera head runs in float32 on the final layer's camera tokens: its
trunk is 4 blocks at dim 2,048 with 16 heads of 128, so its attention is K6's
f32 path on the card, 4 blocks x ``camera_iterations`` launches a forward.
The DPT head runs in ``compute_dtype`` (the scorer's ``dpt_dtype``), frames
in chunks of the largest divisor of B*S not above ``chunk_size``, each
chunk's output written into one preallocated tensor.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as TF

from videogpa_torch.models.vggt.config import VGGTConfig
from videogpa_torch.ops import layers as L
from videogpa_torch.ops.resize import resize_bilinear
from videogpa_torch.ops.transformer import Block, BlockConfig, block_apply


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def inverse_log_transform(y: torch.Tensor) -> torch.Tensor:
    return torch.sign(y) * torch.expm1(y.abs())


def activate_pose(enc: torch.Tensor) -> torch.Tensor:
    """absT_quaR_FoV with the fov through a ReLU (the camera head's fl_act)."""
    return torch.cat([enc[..., :7], torch.relu(enc[..., 7:])], dim=-1)


def _activate_values(xyz: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "exp":
        return torch.exp(xyz)
    if activation == "inv_log":
        return inverse_log_transform(xyz)
    raise ValueError(f"Unknown activation: {activation}")


def activate_head(out: torch.Tensor, activation: str,
                  conf_activation: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, C, H, W) -> ((B, H, W, C-1) points or depth, (B, H, W) conf), f32.
    VGGT's heads: "exp" (depth) or "inv_log" (points), conf "expp1"; the
    JAX package's other activations serve DA3 (``models/da3/heads.py``)."""
    fmap = out.permute(0, 2, 3, 1).float()
    xyz, conf = fmap[..., :-1], fmap[..., -1]
    if conf_activation != "expp1":
        raise ValueError(f"Unknown conf_activation: {conf_activation}")
    return _activate_values(xyz, activation), 1 + torch.exp(conf)


def _activate_single(out: torch.Tensor, activation: str) -> torch.Tensor:
    """A head without confidence (DA3's mono DPT): (B, C, H, W) -> (B, H, W, C)."""
    return _activate_values(out.permute(0, 2, 3, 1).float(), activation)


# ---------------------------------------------------------------------------
# Camera head
# ---------------------------------------------------------------------------

def camera_block_cfg(cfg: VGGTConfig) -> BlockConfig:
    return BlockConfig(dim=cfg.tokens_dim, num_heads=cfg.num_heads, mlp_ratio=4.0,
                       init_values=0.01)


class CameraHead(nn.Module):
    def __init__(self, cfg: VGGTConfig, device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.cfg = cfg
        dim = cfg.tokens_dim
        bcfg = camera_block_cfg(cfg)
        self.trunk = nn.ModuleList(Block(bcfg, **fk) for _ in range(cfg.camera_trunk_depth))
        self.token_norm = L.LayerNorm(dim, **fk)
        self.trunk_norm = L.LayerNorm(dim, **fk)
        self.empty_pose_tokens = nn.Parameter(torch.zeros((1, 1, 9), **fk))
        self.embed_pose = L.Linear(9, dim, **fk)
        self.poseLN_modulation = L.Linear(dim, 3 * dim, **fk)
        self.pose_branch = L.group(fc1=L.Linear(dim, dim // 2, **fk),
                                   fc2=L.Linear(dim // 2, 9, **fk))


def camera_head_forward(head: CameraHead, tokens_last: torch.Tensor,
                        attn_impl: str = "auto") -> List[torch.Tensor]:
    """tokens_last (B, S, 2C) f32 camera tokens of the final layer -> one
    (B, S, 9) pose encoding per refinement iteration."""
    pose_tokens = head.token_norm(tokens_last)
    B, S, _ = pose_tokens.shape
    pred = None
    preds = []
    for _ in range(head.cfg.camera_iterations):
        inp = (head.empty_pose_tokens.to(pose_tokens.dtype).expand(B, S, 9) if pred is None
               else pred.detach())
        mod = head.poseLN_modulation(TF.silu(head.embed_pose(inp)))
        shift, scale, gate = mod.chunk(3, dim=-1)
        normed = L.layernorm(pose_tokens, eps=1e-6)  # AdaLN: no affine parameters
        x = gate * (normed * (1 + scale) + shift) + pose_tokens
        for blk in head.trunk:
            x = block_apply(blk, x, attn_impl=attn_impl)
        delta = L.mlp(head.pose_branch, head.trunk_norm(x))
        pred = delta if pred is None else pred + delta
        preds.append(activate_pose(pred))
    return preds


# ---------------------------------------------------------------------------
# DPT head
# ---------------------------------------------------------------------------

def _rcu(f: int, **fk) -> nn.Module:
    return L.group(conv1=L.Conv2d(f, f, 3, padding=1, **fk),
                   conv2=L.Conv2d(f, f, 3, padding=1, **fk))


def _fusion_block(f: int, has_residual: bool, **fk) -> nn.Module:
    m = L.group(out_conv=L.Conv2d(f, f, 1, **fk), rcu2=_rcu(f, **fk))
    if has_residual:
        m.add_module("rcu1", _rcu(f, **fk))
    return m


class DPTHead(nn.Module):
    """The DPT head's parameters, named as the JAX tree of ``dpt_head_init``.
    DA3's options: ``feature_only`` (no output head, ``output_conv1`` keeps
    the features' width; GSDPT), ``dim_in`` (token width; the mono trunk's
    C, not 2C), ``sky_head`` (``sky_conv2a`` / ``sky_conv2b`` off the shared
    ``output_conv1`` features) and ``input_norm=False`` (Identity norm).
    ``features`` is the fusion pyramid's width (``cfg.dpt_features`` when
    None; VGGT's track head takes 128)."""

    def __init__(self, cfg: VGGTConfig, output_dim: int, device=None, dtype=None,
                 feature_only: bool = False, dim_in: Optional[int] = None,
                 sky_head: bool = False, input_norm: bool = True,
                 features: Optional[int] = None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        oc, f = cfg.dpt_out_channels, features or cfg.dpt_features
        dim_in = dim_in or cfg.tokens_dim
        self.feature_only = feature_only
        self.norm = L.LayerNorm(dim_in, **fk) if input_norm else nn.Identity()
        self.projects = nn.ModuleList(L.Conv2d(dim_in, c, 1, **fk) for c in oc)
        self.resize0 = L.ConvTranspose2d(oc[0], oc[0], 4, stride=4, **fk)
        self.resize1 = L.ConvTranspose2d(oc[1], oc[1], 2, stride=2, **fk)
        self.resize3 = L.Conv2d(oc[3], oc[3], 3, stride=2, padding=1, **fk)
        self.layer_rn = nn.ModuleList(L.Conv2d(c, f, 3, padding=1, bias=False, **fk) for c in oc)
        self.refinenet1 = _fusion_block(f, True, **fk)
        self.refinenet2 = _fusion_block(f, True, **fk)
        self.refinenet3 = _fusion_block(f, True, **fk)
        self.refinenet4 = _fusion_block(f, False, **fk)
        if feature_only:
            self.output_conv1 = L.Conv2d(f, f, 3, padding=1, **fk)
        else:
            self.output_conv1 = L.Conv2d(f, f // 2, 3, padding=1, **fk)
            self.output_conv2a = L.Conv2d(f // 2, 32, 3, padding=1, **fk)
            self.output_conv2b = L.Conv2d(32, output_dim, 1, **fk)
        if sky_head:
            self.sky_conv2a = L.Conv2d(f // 2, 32, 3, padding=1, **fk)
            self.sky_conv2b = L.Conv2d(32, 1, 1, **fk)


def uv_pos_embed(ph: int, pw: int, channels: int, W: int, H: int, device=None) -> torch.Tensor:
    """UV-grid sinusoidal pos embed (channels, ph, pw), scaled by 0.1
    (``heads.py:208-232``)."""
    aspect = W / H
    diag = (aspect ** 2 + 1.0) ** 0.5
    span_x, span_y = aspect / diag, 1.0 / diag
    xs = torch.linspace(-span_x * (pw - 1) / pw, span_x * (pw - 1) / pw, pw, device=device)
    ys = torch.linspace(-span_y * (ph - 1) / ph, span_y * (ph - 1) / ph, ph, device=device)
    vv, uu = torch.meshgrid(ys, xs, indexing="ij")

    def sincos(pos_flat, dim):
        omega = torch.arange(dim // 2, dtype=torch.float32, device=device) / (dim / 2.0)
        out = pos_flat[:, None] * (1.0 / (100.0 ** omega))[None]
        return torch.cat([torch.sin(out), torch.cos(out)], dim=1)

    half = channels // 2
    emb = torch.cat([sincos(uu.reshape(-1), half), sincos(vv.reshape(-1), half)], dim=-1)
    return emb.reshape(ph, pw, channels).permute(2, 0, 1) * 0.1


def _rcu_apply(m: nn.Module, x: torch.Tensor, inplace_relu: bool = True) -> torch.Tensor:
    # VGGT's ResidualConvUnit applies ReLU(inplace=True) to its input before
    # the skip-add, so the residual adds relu(x), not x (heads.py:235-245);
    # DA3's fusion blocks build ReLU(inplace=False): the skip adds raw x
    xr = torch.relu(x)
    out = m.conv2(torch.relu(m.conv1(xr)))
    return out + (xr if inplace_relu else x)


def _fusion(m: nn.Module, x: torch.Tensor, residual=None, size=None,
            inplace_relu: bool = True) -> torch.Tensor:
    out = x
    if residual is not None:
        out = out + _rcu_apply(m.rcu1, residual, inplace_relu)
    out = _rcu_apply(m.rcu2, out, inplace_relu)
    if size is None:
        size = (out.shape[-2] * 2, out.shape[-1] * 2)
    out = resize_bilinear(out, size, align_corners=True)
    return m.out_conv(out)


def _dpt_core(head: DPTHead, taps: List[torch.Tensor], cfg: VGGTConfig, img_hw,
              activation: str, conf_activation: str, compute_dtype: torch.dtype,
              use_pos_embed: bool = True, with_conf: bool = True, inplace_relu: bool = True,
              down_ratio: int = 1):
    """One chunk: taps are the 4 (K, P, 2C) layer outputs the DPT reads.
    Returns the (K, f, H / down_ratio, W / down_ratio) features with
    ``feature_only``, else (preds, conf or None, sky or None)."""
    H, W = img_hw
    ph, pw = H // cfg.patch_size, W // cfg.patch_size
    pyramid = []
    for i, tokens in enumerate(taps):
        K = tokens.shape[0]
        x = tokens[:, cfg.patch_start_idx:].to(compute_dtype)
        x = head.norm(x)
        x = x.transpose(1, 2).reshape(K, -1, ph, pw)
        x = head.projects[i](x)
        if use_pos_embed:
            x = x + uv_pos_embed(ph, pw, x.shape[1], W, H, x.device).to(x.dtype)
        if i == 0:
            x = head.resize0(x)
        elif i == 1:
            x = head.resize1(x)
        elif i == 3:
            x = head.resize3(x)
        pyramid.append(x)
    l1, l2, l3, l4 = (head.layer_rn[i](p) for i, p in enumerate(pyramid))
    out = _fusion(head.refinenet4, l4, size=l3.shape[-2:], inplace_relu=inplace_relu)
    out = _fusion(head.refinenet3, out, l3, size=l2.shape[-2:], inplace_relu=inplace_relu)
    out = _fusion(head.refinenet2, out, l2, size=l1.shape[-2:], inplace_relu=inplace_relu)
    out = _fusion(head.refinenet1, out, l1, inplace_relu=inplace_relu)
    out = head.output_conv1(out)
    out = resize_bilinear(out, (ph * cfg.patch_size // down_ratio,
                                pw * cfg.patch_size // down_ratio), align_corners=True)
    if use_pos_embed:
        out = out + uv_pos_embed(out.shape[-2], out.shape[-1], out.shape[1], W, H,
                                 out.device).to(out.dtype)
    if head.feature_only:
        return out
    feat = out
    out = head.output_conv2b(torch.relu(head.output_conv2a(feat)))
    if with_conf:
        preds, conf = activate_head(out, activation, conf_activation)
    else:  # DA3's mono DPT: every channel is the prediction
        preds, conf = _activate_single(out, activation), None
    sky = None
    if hasattr(head, "sky_conv2a"):  # sky_activation "relu"
        sky = torch.relu(head.sky_conv2b(torch.relu(head.sky_conv2a(feat)))[:, 0].float())
    return preds, conf, sky


def dpt_head_forward(head: DPTHead, layer_outputs: torch.Tensor, cfg: VGGTConfig, img_hw,
                     activation: str = "exp", conf_activation: str = "expp1",
                     chunk_size: int = 8, compute_dtype: torch.dtype = torch.float32,
                     use_pos_embed: bool = True, with_conf: bool = True,
                     inplace_relu: bool = True, down_ratio: int = 1):
    """layer_outputs (L, B, S, P, 2C); ``cfg.dpt_intermediate_layers`` index
    its first axis. Returns (preds (B, S, H, W, out-1), conf (B, S, H, W)),
    f32, with ``sky`` (B, S, H, W) third where the head has one; conf is None
    without ``with_conf`` (then preds keep every channel); with
    ``feature_only`` the (B, S, f, H, W) features in ``compute_dtype``.
    ``inplace_relu=False`` gives DA3's fusion residual (raw x);
    ``down_ratio`` divides the output's height and width (the track head's
    features: 2)."""
    _, B, S, P, C2 = layer_outputs.shape
    BS = B * S
    chunk = max(c for c in range(1, min(chunk_size, BS) + 1) if BS % c == 0)
    flat = layer_outputs.reshape(layer_outputs.shape[0], BS, P, C2)
    taps = [flat[i] for i in cfg.dpt_intermediate_layers]
    outs = None
    for s in range(0, BS, chunk):
        got = _dpt_core(head, [t[s:s + chunk] for t in taps], cfg, img_hw, activation,
                        conf_activation, compute_dtype, use_pos_embed, with_conf,
                        inplace_relu, down_ratio)
        got = (got,) if head.feature_only else got
        if outs is None:  # one preallocated output each, filled chunk by chunk
            outs = [None if t is None else t.new_empty((BS,) + t.shape[1:]) for t in got]
        for acc, t in zip(outs, got):
            if t is not None:
                acc[s:s + chunk] = t
    outs = [None if t is None else t.reshape(B, S, *t.shape[1:]) for t in outs]
    if head.feature_only:
        return outs[0]
    return tuple(outs) if outs[2] is not None else tuple(outs[:2])

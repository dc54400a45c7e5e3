"""DA3's DINOv2 AA-ViT: alternating local and global attention
(``videogpa_tpu/models/da3/vit.py``).

- blocks [0, alt_start): plain DINOv2 blocks attending within a frame;
- with S >= ``ref_view_threshold`` views (and no camera token from the
  caller), a reference view is selected from the cls tokens at the input of
  block alt_start - 1 and the views are reordered, reference first;
- at block alt_start the cls slot takes the camera token (slot 0 for the
  reference view, slot 1 for the rest);
- blocks [alt_start, depth): QK-norm and 2D RoPE; odd blocks attend over
  all views of a clip (positions collapsed to the constant (1, 1), cls at
  0), even ones within a frame;
- at each out layer: [last local output || current output] (2C channels),
  the final norm (eps 1e-5, the blocks use 1e-6) on the global half only,
  the camera token taken before it; the views back in their order.

At DA3-Large's 518^2 a frame is 1 + 37^2 = 1,370 tokens: the frame blocks
are short rows (K4 on the card), the global blocks 10 x 1,370 keys a clip
(K1, or K8 in the int8 mode).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn

from videogpa_torch.device import resolve_device
from videogpa_torch.models.da3.config import DA3Config
from videogpa_torch.ops import layers as L
from videogpa_torch.ops.resize import resize_bicubic
from videogpa_torch.ops.transformer import Block, BlockConfig, LayerScale, block_apply


def _pre_cfg(cfg: DA3Config) -> BlockConfig:
    return BlockConfig(dim=cfg.embed_dim, num_heads=cfg.num_heads, mlp_ratio=cfg.mlp_ratio,
                       init_values=cfg.init_values, qk_norm=False, rope_base=0.0,
                       norm_eps=1e-6, ffn=cfg.ffn)


def _alt_cfg(cfg: DA3Config) -> BlockConfig:
    return BlockConfig(dim=cfg.embed_dim, num_heads=cfg.num_heads, mlp_ratio=cfg.mlp_ratio,
                       init_values=cfg.init_values, qk_norm=True, rope_base=cfg.rope_base,
                       norm_eps=1e-6, ffn=cfg.ffn)


class AAViT(nn.Module):
    """The backbone's parameters, named as the JAX tree of ``aavit_init``;
    ``forward`` is :func:`aavit_forward`."""

    def __init__(self, cfg: DA3Config, device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.cfg = cfg
        C = cfg.embed_dim
        n_grid = cfg.img_size // cfg.patch_size
        self.patch_embed = L.Conv2d(3, C, kernel_size=cfg.patch_size, stride=cfg.patch_size,
                                    **fk)
        self.cls_token = nn.Parameter(torch.zeros((1, 1, C), **fk))
        self.pos_embed = nn.Parameter(torch.zeros((1, 1 + n_grid * n_grid, C), **fk))
        self.camera_token = nn.Parameter(torch.zeros((1, 2, C), **fk))
        self.blocks_pre = nn.ModuleList(Block(_pre_cfg(cfg), **fk)
                                        for _ in range(cfg.alt_start))
        self.blocks_alt = nn.ModuleList(Block(_alt_cfg(cfg), **fk)
                                        for _ in range(cfg.depth - cfg.alt_start))
        self.norm = L.LayerNorm(C, eps=1e-5, **fk)

    def forward(self, images: torch.Tensor, **kwargs):
        return aavit_forward(self, images, **kwargs)


@torch.no_grad()
def _drawn(build, generator, device):
    """``build(device="meta")`` allocated on ``device`` and drawn as the JAX
    initialisers draw (different numbers): kaiming-uniform linears and
    convs, layer norms ones/zeros, LayerScale at its init value. Returns
    (module, generator); the generator lives on ``device`` (default: seeded
    with 0)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    model = build(device="meta").to_empty(device=device)
    L.kaiming_uniform_init_(model, generator)
    for m in model.modules():
        if isinstance(m, LayerScale):
            m.gamma.fill_(m.init_values)
    return model, generator


@torch.no_grad()
def _draw_tokens_(model: AAViT, generator: torch.Generator) -> None:
    """pos-embed N(0, 0.02), the camera token N(0, 1), the cls token zero."""
    model.pos_embed.normal_(0.0, 0.02, generator=generator)
    model.camera_token.normal_(0.0, 1.0, generator=generator)
    model.cls_token.zero_()


def aavit_init(cfg: DA3Config, generator: Optional[torch.Generator] = None, device=None,
               dtype: torch.dtype = torch.float32) -> AAViT:
    """A random AA-ViT on ``device`` in ``dtype`` (``_drawn``, then the tokens)."""
    model, generator = _drawn(lambda **fk: AAViT(cfg, **fk), generator, device)
    _draw_tokens_(model, generator)
    return model.to(dtype).requires_grad_(False)


def _interp_pos(pos_embed: torch.Tensor, hg: int, wg: int) -> torch.Tensor:
    """(1, 1 + M*M, C) -> (1, 1 + hg*wg, C). DA3's DINOv2 keeps
    ``interpolate_offset=0.1``: torch maps source coordinates with the given
    scale factor (g + 0.1) / M, not g / M, and the resize is not antialiased."""
    n = pos_embed.shape[1] - 1
    m = int(round(n ** 0.5))
    if (hg, wg) == (m, m):
        return pos_embed
    pe = pos_embed[:, 1:].reshape(1, m, m, -1).permute(0, 3, 1, 2)
    pe = resize_bicubic(pe.float(), (hg, wg), antialias=False,
                        scale_override=(m / (hg + 0.1), m / (wg + 0.1)))
    pe = pe.permute(0, 2, 3, 1).reshape(1, hg * wg, -1).to(pos_embed.dtype)
    return torch.cat([pos_embed[:, :1], pe], dim=1)


def select_reference_view(x: torch.Tensor, strategy: str = "saddle_balanced") -> torch.Tensor:
    """The reference view of each clip from its cls tokens: x (B, S, P, C)
    -> (B,) int64. ``first``, ``middle``, ``saddle_balanced`` (the view
    closest to the median of similarity, norm and variance, each min-max
    normalised over the views) or ``saddle_sim_range`` (the largest max-min
    similarity range). Ties go to the first index, as ``jnp.argmin``'s."""
    B, S = x.shape[:2]
    if strategy == "first":
        return torch.zeros((B,), dtype=torch.int64, device=x.device)
    if strategy == "middle":
        return torch.full((B,), S // 2, dtype=torch.int64, device=x.device)
    cls = x[:, :, 0].float()
    feat = cls / torch.linalg.vector_norm(cls, dim=-1, keepdim=True)
    sim = torch.einsum("bsc,btc->bst", feat, feat)
    sim = sim - torch.eye(S, device=x.device)[None]
    if strategy == "saddle_sim_range":
        return (sim.amax(-1) - sim.amin(-1)).argmax(dim=1)
    if strategy != "saddle_balanced":
        raise ValueError(f"unknown ref_view_strategy {strategy!r}; expected one of "
                         "first, middle, saddle_balanced, saddle_sim_range")
    sim_score = sim.sum(-1) / (S - 1)
    feat_norm = torch.linalg.vector_norm(cls, dim=-1)
    feat_var = feat.var(dim=-1, unbiased=False)

    def norm_metric(m):
        mn = m.amin(dim=1, keepdim=True)
        mx = m.amax(dim=1, keepdim=True)
        return (m - mn) / (mx - mn + 1e-8)

    balance = ((norm_metric(sim_score) - 0.5).abs() + (norm_metric(feat_norm) - 0.5).abs()
               + (norm_metric(feat_var) - 0.5).abs())
    return balance.argmin(dim=1)


def _reorder_perm(b_idx: torch.Tensor, S: int) -> torch.Tensor:
    """(B,) reference indices -> (B, S) permutation [ref, the others in order]."""
    pos = torch.arange(S, device=b_idx.device)[None]
    key = torch.where(pos == b_idx[:, None], -1, pos)
    return torch.argsort(key, dim=1, stable=True)


def _take_views(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """x (B, S, ...) with each clip's views in the order of perm (B, S)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], perm]


def aavit_forward(model: AAViT, images: torch.Tensor, cam_token: Optional[torch.Tensor] = None,
                  attn_impl: str = "auto") -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """images (B, S, 3, H, W), ImageNet-normalised, in the compute dtype.

    Returns per out layer (tokens (B, S, P_patch, 2C) with the global half
    final-normed and the cls slot dropped, camera token (B, S, 2C)).
    """
    cfg = model.cfg
    B, S, _, H, W = images.shape
    hg, wg = H // cfg.patch_size, W // cfg.patch_size
    C = cfg.embed_dim
    dev = images.device

    x = model.patch_embed(images.reshape(B * S, 3, H, W))
    x = x.reshape(B * S, C, hg * wg).transpose(1, 2)
    x = torch.cat([model.cls_token.to(x.dtype).expand(B * S, 1, C), x], dim=1)
    x = x + _interp_pos(model.pos_embed, hg, wg).to(x.dtype)
    P = x.shape[1]

    # RoPE positions: patch (y, x) + 1 with cls at 0; the global blocks see
    # every patch at the constant (1, 1)
    yy, xx = torch.meshgrid(torch.arange(hg, device=dev), torch.arange(wg, device=dev),
                            indexing="ij")
    ppos = torch.stack([yy, xx], dim=-1).reshape(1, hg * wg, 2) + 1
    zero = torch.zeros((1, 1, 2), dtype=ppos.dtype, device=dev)
    pos_local = torch.cat([zero, ppos], dim=1).expand(B * S, P, 2)
    pos_nodiff = torch.cat([zero, torch.ones_like(ppos)], dim=1).expand(B * S, P, 2)
    pos_nodiff = pos_nodiff.reshape(B, S * P, 2)

    # the selection reads the INPUT of block alt_start - 1; a frame-wise block
    # commutes with a view permutation, so the reorder follows that block
    select = S >= cfg.ref_view_threshold and cam_token is None and cfg.alt_start >= 1
    n_head = len(model.blocks_pre) - 1 if select else len(model.blocks_pre)
    for blk in model.blocks_pre[:n_head]:
        x = block_apply(blk, x, attn_impl=attn_impl)
    perm = None
    if select:
        b_idx = select_reference_view(x.reshape(B, S, P, C), cfg.ref_view_strategy)
        x = block_apply(model.blocks_pre[-1], x, attn_impl=attn_impl)
        perm = _reorder_perm(b_idx, S)
        x = _take_views(x.reshape(B, S, P, C), perm)
    else:
        x = x.reshape(B, S, P, C)

    if cam_token is None:
        ct = model.camera_token.to(x.dtype)
        cam = torch.cat([ct[:, :1].expand(B, 1, C), ct[:, 1:].expand(B, S - 1, C)], dim=1)
    else:
        cam = cam_token.to(x.dtype)
    x = torch.cat([cam[:, :, None], x[:, :, 1:]], dim=2)

    local_x = x
    outputs = {}
    for j, blk in enumerate(model.blocks_alt):
        i = cfg.alt_start + j
        if i % 2 == 1:  # global
            x = block_apply(blk, x.reshape(B, S * P, C), pos_nodiff,
                            attn_impl).reshape(B, S, P, C)
        else:  # local
            x = block_apply(blk, x.reshape(B * S, P, C), pos_local,
                            attn_impl).reshape(B, S, P, C)
            local_x = x
        if i in cfg.out_layers:
            outputs[i] = torch.cat([local_x, x], dim=-1)

    inv_perm = torch.argsort(perm, dim=1, stable=True) if perm is not None else None
    feats = []
    for i in cfg.out_layers:
        out = outputs[i]
        if inv_perm is not None:
            out = _take_views(out, inv_perm)
        normed = torch.cat([out[..., :C], model.norm(out[..., C:])], dim=-1)
        feats.append((normed[:, :, 1:], out[:, :, 0]))
    return feats

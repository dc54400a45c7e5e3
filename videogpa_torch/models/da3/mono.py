"""DA3's mono / metric presets (``videogpa_tpu/models/da3/mono.py``): a plain
DINOv2 trunk, one DPT head with a sky branch, and the sky post-processing.

The reference's ``configs/da3mono-large.yaml`` / ``da3metric-large.yaml``:
ViT-L, out layers (4, 11, 17, 23), alternating attention off
(``alt_start: -1``), one DPT head over the trunk's C channels (not 2C) with
an Identity input norm and a sky head off the shared ``output_conv1``
features. Every block attends within a frame: at 518^2 each is a short row
of 1,370 tokens (K4 on the card). The trunk's final norm has eps 1e-5, the
blocks' 1e-6; the trunk keeps only the out layers' activations, as the JAX
package's segmented scan does.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from videogpa_torch.models.da3.config import DA3Config
from videogpa_torch.models.da3.model import _normalised_upload
from videogpa_torch.models.da3.vit import _drawn, _interp_pos, _pre_cfg
from videogpa_torch.models.vggt.config import VGGTConfig
from videogpa_torch.models.vggt.heads import DPTHead, dpt_head_forward
from videogpa_torch.ops import layers as L
from videogpa_torch.ops.transformer import Block, block_apply


def mono_config(large: bool = True) -> DA3Config:
    """da3mono-large / da3metric-large trunk shape (alternating attention off);
    ``large`` is taken and ignored, as in the JAX package."""
    return DA3Config.mono_large()


def _head_vcfg(cfg: DA3Config) -> VGGTConfig:
    return VGGTConfig(embed_dim=cfg.embed_dim, num_register_tokens=0,
                      dpt_features=cfg.dpt_features, dpt_out_channels=cfg.dpt_out_channels,
                      dpt_intermediate_layers=(0, 1, 2, 3), patch_size=cfg.patch_size)


class MonoViT(nn.Module):
    """The plain trunk's parameters, named as the JAX tree of ``mono_init``'s
    ``backbone`` (``aavit_init`` without ``camera_token`` and ``blocks_alt``)."""

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
        self.blocks_pre = nn.ModuleList(Block(_pre_cfg(cfg), **fk) for _ in range(cfg.depth))
        self.norm = L.LayerNorm(C, eps=1e-5, **fk)


class DA3Mono(nn.Module):
    """A mono / metric net (``mono_init``'s tree); ``forward`` is
    :func:`mono_forward`. ``input_norm`` puts a LayerNorm before the DPT's
    projections (``convert_da3_mono`` builds it where a checkpoint holds
    ``head.norm``); ``mono_init``'s head has none."""

    def __init__(self, cfg: DA3Config, input_norm: bool = False, device=None, dtype=None):
        super().__init__()
        fk = {"device": device, "dtype": dtype}
        self.cfg = cfg
        self.backbone = MonoViT(cfg, **fk)
        self.head = DPTHead(_head_vcfg(cfg), output_dim=1, dim_in=cfg.embed_dim, sky_head=True,
                            input_norm=input_norm, **fk)

    def forward(self, images: torch.Tensor, **kwargs) -> Dict[str, torch.Tensor]:
        return mono_forward(self, images, **kwargs)


@torch.no_grad()
def mono_init(cfg: DA3Config, generator: Optional[torch.Generator] = None, device=None,
              dtype: torch.dtype = torch.float32) -> DA3Mono:
    """A random mono net on ``device`` (``vit._drawn``, then pos-embed
    N(0, 0.02) and a zero cls token): the trunk in ``dtype``, the head f32,
    as the heads run. ``generator`` lives on ``device`` (default: seeded 0)."""
    model, generator = _drawn(lambda **fk: DA3Mono(cfg, **fk), generator, device)
    model.backbone.pos_embed.normal_(0.0, 0.02, generator=generator)
    model.backbone.cls_token.zero_()
    model.backbone.to(dtype)
    return model.requires_grad_(False)


def mono_vit_forward(model: MonoViT, images: torch.Tensor,
                     attn_impl: str = "auto") -> List[torch.Tensor]:
    """images (B, 3, H, W) -> the out layers' tokens, each (B, P, C) with the
    cls slot and the final norm (eps 1e-5) applied, in the images' dtype."""
    cfg = model.cfg
    B, _, H, W = images.shape
    hg, wg = H // cfg.patch_size, W // cfg.patch_size
    C = cfg.embed_dim
    x = model.patch_embed(images)
    x = x.reshape(B, C, hg * wg).transpose(1, 2)
    x = torch.cat([model.cls_token.to(x.dtype).expand(B, 1, C), x], dim=1)
    x = x + _interp_pos(model.pos_embed, hg, wg).to(x.dtype)
    kept = {}
    for i, blk in enumerate(model.blocks_pre[:max(cfg.out_layers) + 1]):
        x = block_apply(blk, x, attn_impl=attn_impl)
        if i in cfg.out_layers:
            kept[i] = model.norm(x)
    return [kept[i] for i in cfg.out_layers]


def mono_forward(model: DA3Mono, images: torch.Tensor, attn_impl: str = "auto",
                 compute_dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """images (B, S, 3, H, W), ImageNet-normalised -> {"depth", "sky"}, each
    (B, S, H, W) f32. The trunk runs in ``compute_dtype``, the head in f32."""
    B, S, _, H, W = images.shape
    taps = mono_vit_forward(model.backbone, images.reshape(B * S, 3, H, W).to(compute_dtype),
                            attn_impl)
    # every frame its own clip of one view: (4, B*S, 1, P, C), f32 as the heads run
    tokens = torch.stack([t.float() for t in taps])[:, :, None]
    depth, _, sky = dpt_head_forward(model.head, tokens, _head_vcfg(model.cfg), (H, W),
                                     activation="exp", use_pos_embed=False, with_conf=False,
                                     inplace_relu=False)
    return {"depth": depth[..., 0].reshape(B, S, H, W), "sky": sky.reshape(B, S, H, W)}


# ---------------------------------------------------------------------------
# sky post-processing (reference model/da3.py:155-179, utils/alignment.py)
# ---------------------------------------------------------------------------

def compute_sky_mask(sky: np.ndarray, threshold: float = 0.3) -> np.ndarray:
    """True where NOT sky (reference utils/alignment.py:54-66)."""
    return sky < threshold


def apply_mono_sky_postprocess(depth: np.ndarray, sky: Optional[np.ndarray],
                               threshold: float = 0.3) -> np.ndarray:
    """Set sky regions to the 99th-percentile non-sky depth."""
    if sky is None:
        return depth
    non_sky = compute_sky_mask(sky, threshold)
    if non_sky.sum() <= 10 or (~non_sky).sum() <= 10:
        return depth
    vals = depth[non_sky]
    if vals.size > 100_000:
        rng = np.random.default_rng(0)
        vals = vals[rng.integers(0, vals.size, 100_000)]
    max_depth = float(np.quantile(vals, 0.99))
    out = depth.copy()
    out[~non_sky] = max_depth
    return out


@torch.no_grad()
def mono_inference(model: DA3Mono, frames: np.ndarray, attn_impl: str = "auto",
                   compute_dtype: torch.dtype = torch.bfloat16,
                   sky_postprocess: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Per-frame monocular depth and sky map of (S, H, W, 3) uint8 frames
    (sides divisible by 14) on the model's device. Returns (depth, sky),
    each (S, H, W) f32 numpy."""
    _, x = _normalised_upload(frames, next(model.parameters()).device)
    out = mono_forward(model, x, attn_impl, compute_dtype)
    depth = out["depth"][0].cpu().numpy()
    sky = out["sky"][0].cpu().numpy()
    if sky_postprocess:
        depth = np.stack([apply_mono_sky_postprocess(d, s) for d, s in zip(depth, sky)])
    return depth, sky

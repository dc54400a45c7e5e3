"""Resizing with PyTorch's pixel models (``videogpa_tpu/ops/resize.py``).

The JAX package gathers explicitly to reproduce ``F.interpolate`` and
``F.grid_sample``; here ``resize_bilinear`` is ``F.interpolate`` itself
(held against the JAX gathers in the tests), and the bicubic resize of
the pos-embeds (antialiased for VGGT, plain with a scale override for DA3)
uses the same host-side weight matrices as the JAX package (copied, numpy
only).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def resize_bilinear(x: torch.Tensor, out_hw, align_corners: bool = False) -> torch.Tensor:
    """Resize (..., H, W) to (..., H', W'), bilinear, edge-clamped."""
    Ho, Wo = (int(s) for s in out_hw)
    lead = x.shape[:-2]
    xf = x if x.is_floating_point() else x.float()
    y = F.interpolate(xf.reshape(-1, 1, *x.shape[-2:]), size=(Ho, Wo), mode="bilinear",
                      align_corners=align_corners)
    return y.reshape(*lead, Ho, Wo)


def grid_sample_bilinear(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                         batched: bool = False) -> torch.Tensor:
    """Sample an (H, W) image at float pixel coords (u, v) with zero padding,
    as ``F.grid_sample(align_corners=True, padding_mode='zeros')``. An
    (H, W, C...) image samples every channel in one gather: the result is
    u.shape + (C...), each channel as the (H, W) call would give it.

    ``batched``: img is (B, H, W, C...) and u, v are (B, M...); entry b of
    the result, (M..., C...), is the unbatched call on img[b], u[b], v[b],
    with one gather a tap over all B images."""
    lead = 1 if batched else 0
    H, W = img.shape[lead:lead + 2]
    chans = (None,) * (img.dim() - 2 - lead)
    bi = ((torch.arange(img.shape[0], device=img.device).reshape((-1,) + (1,) * (u.dim() - 1)),)
          if batched else ())
    x0 = torch.floor(u).to(torch.int64)
    y0 = torch.floor(v).to(torch.int64)
    x1, y1 = x0 + 1, y0 + 1
    wx = (u - x0.to(u.dtype))[(...,) + chans]
    wy = (v - y0.to(v.dtype))[(...,) + chans]

    def tap(yi, xi):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        val = img[bi + (yi.clamp(0, H - 1), xi.clamp(0, W - 1))]
        return torch.where(inb[(...,) + chans], val, 0.0)

    return (tap(y0, x0) * (1 - wy) * (1 - wx) + tap(y0, x1) * (1 - wy) * wx
            + tap(y1, x0) * wy * (1 - wx) + tap(y1, x1) * wy * wx)


def _cubic_kernel(t: np.ndarray, a: float) -> np.ndarray:
    at = np.abs(t)
    return np.where(
        at <= 1,
        (a + 2) * at ** 3 - (a + 3) * at ** 2 + 1,
        np.where(at < 2, a * at ** 3 - 5 * a * at ** 2 + 8 * a * at - 4 * a, 0.0),
    )


def _bicubic_weights_1d(in_size: int, out_size: int, antialias: bool = True,
                        scale_override: float = 0.0) -> np.ndarray:
    """(out_size, in_size) weights of torch's bicubic ``F.interpolate``
    (``videogpa_tpu/ops/resize.py::_bicubic_weights_1d``).

    ``antialias``: the PIL-style a = -0.5 kernel, half-pixel centres,
    clipped borders, normalised rows. Otherwise the a = -0.75 kernel on four
    edge-clamped taps. ``scale_override`` > 0 maps source coordinates with
    that in/out ratio instead of ``in_size / out_size``, as torch does when
    the caller passes ``scale_factor=`` (DINOv2's ``interpolate_offset``).
    """
    Wt = np.zeros((out_size, in_size), np.float64)
    scale = scale_override if scale_override > 0 else in_size / out_size
    if antialias:
        s = max(scale, 1.0)
        support = 2.0 * s
        for i in range(out_size):
            center = scale * (i + 0.5)
            lo = max(0, int(center - support + 0.5))
            hi = min(in_size, int(center + support + 0.5))
            j = np.arange(lo, hi)
            w = _cubic_kernel((j - center + 0.5) / s, a=-0.5)
            Wt[i, j] = w / w.sum()
    else:
        for i, c in enumerate((np.arange(out_size) + 0.5) * scale - 0.5):
            f = int(np.floor(c))
            j = np.arange(f - 1, f + 3)
            np.add.at(Wt[i], np.clip(j, 0, in_size - 1), _cubic_kernel(j - c, a=-0.75))
    return Wt.astype(np.float32)


def resize_bicubic(x: torch.Tensor, out_hw, antialias: bool = True,
                   scale_override=(0.0, 0.0)) -> torch.Tensor:
    """Resize (..., H, W) as torch's bicubic ``F.interpolate``, as two products
    with precomputed weight matrices; f32 math. The default is the
    antialiased resize of VGGT's DINOv2 pos-embed; DA3's passes
    ``antialias=False`` with its ``scale_override`` (per-axis in/out ratios)."""
    H, W = x.shape[-2:]
    Ho, Wo = out_hw
    wh = torch.from_numpy(_bicubic_weights_1d(H, Ho, antialias, scale_override[0])).to(x.device)
    ww = torch.from_numpy(_bicubic_weights_1d(W, Wo, antialias, scale_override[1])).to(x.device)
    y = torch.einsum("oh,...hw->...ow", wh, x.float())
    y = torch.einsum("ow,...hw->...ho", ww, y)
    return y.to(x.dtype)

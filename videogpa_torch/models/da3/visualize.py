"""Depth / image visualization helpers (host-side numpy), a copy of
``videogpa_tpu/models/da3/visualize.py``.

Parity targets (reference ``depth_anything_3/utils/visualize.py:23-120`` and
``utils/layout_helpers.py:120-216``):

- ``visualize_depth``: inverse-depth percentile normalization colored with a
  matplotlib colormap (Spectral, flipped) — the scheme used for every
  reference depth_vis artifact.
- ``apply_color_map`` / ``apply_color_map_to_image``: plain [0, 1] -> RGB
  colormap application.
- ``cat`` / ``hcat`` / ``vcat`` / ``add_border``: flexbox-style image
  layout over (channel, height, width) float arrays with alignment, gap
  and gap color.

The reference operates on torch tensors; these are numpy (visualization is
host-side IO).
"""

from __future__ import annotations

from typing import Iterable, Sequence, Union

import numpy as np

Color = Union[int, float, Sequence[float], np.ndarray]


def _sanitize_color(color: Color) -> np.ndarray:
    if isinstance(color, np.ndarray):
        color = color.tolist()
    if isinstance(color, Iterable):
        color = list(color)
    else:
        color = [color]
    return np.asarray(color, np.float32)


def visualize_depth(
    depth: np.ndarray,
    depth_min=None,
    depth_max=None,
    percentile: float = 2,
    ret_minmax: bool = False,
    ret_type=np.uint8,
    cmap: str = "Spectral",
):
    """Color a (H, W) depth map via inverse-depth percentile normalization.

    Matches the reference scheme (``utils/visualize.py:23-79``): invalid
    (<= 0) pixels stay at 0, valid pixels are mapped to disparity, the
    [percentile, 100-percentile] disparity range is normalized, flipped
    (near = warm end of Spectral) and colored. Returns (H, W, 3) uint8 by
    default; float32/float64 in [0, 1] via ``ret_type``.
    """
    import matplotlib

    disp = np.zeros_like(depth, np.float64)
    valid = depth > 0
    disp[valid] = 1.0 / depth[valid]
    if depth_min is None:
        depth_min = (
            0 if valid.sum() <= 10 else np.percentile(disp[valid], percentile)
        )
    if depth_max is None:
        depth_max = (
            0 if valid.sum() <= 10
            else np.percentile(disp[valid], 100 - percentile)
        )
    if depth_min == depth_max:
        depth_min, depth_max = depth_min - 1e-6, depth_max + 1e-6
    cm = matplotlib.colormaps[cmap]
    norm = np.clip((disp - depth_min) / (depth_max - depth_min), 0, 1)
    colored = cm(1.0 - norm)[..., :3]
    if ret_type == np.uint8:
        colored = (colored * 255.0).astype(np.uint8)
    elif ret_type in (np.float32, np.float64):
        colored = colored.astype(ret_type)
    else:
        raise ValueError(f"Invalid return type: {ret_type}")
    if ret_minmax:
        return colored, depth_min, depth_max
    return colored


def apply_color_map(x: np.ndarray, color_map: str = "inferno") -> np.ndarray:
    """(*batch) values in [0, 1] -> (*batch, 3) float32 RGB."""
    import matplotlib

    cm = matplotlib.colormaps[color_map]
    return cm(np.clip(np.asarray(x, np.float64), 0, 1))[..., :3].astype(
        np.float32
    )


def apply_color_map_to_image(
    image: np.ndarray, color_map: str = "inferno"
) -> np.ndarray:
    """(*batch, H, W) -> (*batch, 3, H, W) float32 RGB."""
    return np.moveaxis(apply_color_map(image, color_map), -1, -3)


# ---------------------------------------------------------------------------
# layout helpers: images are (channel, height, width) float arrays
# ---------------------------------------------------------------------------

_MAIN_DIM = {"horizontal": 2, "vertical": 1}
_CROSS_DIM = {"horizontal": 1, "vertical": 2}


def _pad_cross(image: np.ndarray, axis: str, length: int, align: str,
               gap_color: np.ndarray) -> np.ndarray:
    cross = _CROSS_DIM[axis]
    short = length - image.shape[cross]
    if short == 0:
        return image.astype(np.float32)
    offset = {"start": 0, "center": short // 2, "end": short}[align]
    shape = list(image.shape)
    shape[cross] = length
    base = np.ones(shape, np.float32) * gap_color[:, None, None]
    sel = [slice(None)] * 3
    sel[cross] = slice(offset, offset + image.shape[cross])
    base[tuple(sel)] = image
    return base


def cat(main_axis: str, *images: np.ndarray, align: str = "center",
        gap: int = 8, gap_color: Color = 1) -> np.ndarray:
    """Arrange (C, H, W) images in a line, flexbox-style."""
    gc = _sanitize_color(gap_color)
    cross_len = max(im.shape[_CROSS_DIM[main_axis]] for im in images)
    padded = [_pad_cross(im, main_axis, cross_len, align, gc) for im in images]
    if gap > 0:
        c = images[0].shape[0]
        sep_shape = [c, gap, gap]
        sep_shape[_CROSS_DIM[main_axis]] = cross_len
        sep = np.ones(sep_shape, np.float32) * gc[:, None, None]
        inter = []
        for im in padded:
            if inter:
                inter.append(sep)
            inter.append(im)
        padded = inter
    return np.concatenate(padded, axis=_MAIN_DIM[main_axis])


def hcat(*images: np.ndarray, align: str = "start", gap: int = 8,
         gap_color: Color = 1) -> np.ndarray:
    return cat(
        "horizontal", *images,
        align={"start": "start", "center": "center", "end": "end",
               "top": "start", "bottom": "end"}[align],
        gap=gap, gap_color=gap_color,
    )


def vcat(*images: np.ndarray, align: str = "start", gap: int = 8,
         gap_color: Color = 1) -> np.ndarray:
    return cat(
        "vertical", *images,
        align={"start": "start", "center": "center", "end": "end",
               "left": "start", "right": "end"}[align],
        gap=gap, gap_color=gap_color,
    )


def add_border(image: np.ndarray, border: int = 8,
               color: Color = 1) -> np.ndarray:
    c, h, w = image.shape
    out = np.empty((c, h + 2 * border, w + 2 * border), np.float32)
    out[:] = _sanitize_color(color)[:, None, None]
    out[:, border:h + border, border:w + border] = image
    return out

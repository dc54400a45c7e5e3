"""Point-cloud splatting into cameras with a z-buffer
(``videogpa_tpu/geometry/projection.py``).

Each view projects the colored cloud, rounds to integer pixels and keeps,
per pixel, the nearest point (lowest point id among depth ties). Three
lowerings, chosen by ``batch_reproject(zbuffer_impl=...)`` as in the JAX
package (the scorer reads ``VIDEOGPA_ZBUFFER``, default "packed"):

- "scatter" (``project_points_zbuffer``): exact, two scatter-min passes per
  view (nearest depth, then lowest id at that depth), both through K5
  (``scatter_min_u32``): positive f32 depths order as their uint32 bits;
- "sorted" (``project_points_zbuffer_sorted``): exact, a stable sort and a
  binary search in plain PyTorch, no scatter;
- "packed" (``reproject_views_packed``): ONE K5 launch for all views over a
  (quantised depth, point id) uint32 key.

Invalid points land in a dump slot past each view's canvas, so every
shape is fixed by the inputs' shapes.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import torch

from videogpa_torch.geometry.zbuffer_kernel import SENTINEL, scatter_min_u32

_PACKED_MAX_POINTS = 1 << 24


def _to_pixel(x: torch.Tensor) -> torch.Tensor:
    """Round half to even, then convert as XLA converts f32 to int32:
    saturating, NaN -> 0. A degenerate camera (fov 0 -> infinite focal)
    gives NaN coordinates, which the JAX package lands on pixel 0."""
    r = torch.nan_to_num(torch.round(x), nan=0.0)
    return r.clamp(-2.0 ** 31, 2.0 ** 31 - 1).to(torch.int64)


def _project(points, K, E, H, W, valid):
    """(z, pixel index or H*W, ok) of one view; f32 math, pixel coords reach
    ~W where bf16 ulps are whole pixels."""
    R = E[:3, :3].float()
    t = E[:3, 3].float()
    pc_cam = points.float() @ R.T + t
    pc_proj = pc_cam @ K.float().T
    z = pc_proj[:, 2]
    u = _to_pixel(pc_proj[:, 0] / (z + 1e-8))
    v = _to_pixel(pc_proj[:, 1] / (z + 1e-8))
    ok = (u >= 0) & (u < W) & (v >= 0) & (v < H) & (z > 0)
    if valid is not None:
        ok = ok & valid
    lin = torch.where(ok, v * W + u, H * W)
    return z, lin, ok


def _paint(ids, hit, colors, bg, shape):
    """Canvas of the winners' uint8-quantised colors, ``bg`` where no point hit."""
    c8 = torch.floor(torch.clamp(colors.float(), 0.0, 255.0))
    bgc = torch.tensor(bg, dtype=c8.dtype, device=c8.device)
    px = torch.where(hit[..., None], c8[torch.where(hit, ids, 0)], bgc)
    return px.reshape(shape)


def project_points_zbuffer(points: torch.Tensor, colors: torch.Tensor, K: torch.Tensor,
                           E: torch.Tensor, H: int, W: int,
                           valid: Optional[torch.Tensor] = None,
                           bg: Tuple[float, float, float] = (0.0, 0.0, 0.0)) -> torch.Tensor:
    """Render one view exactly: points (N, 3) world, colors (N, 3) in
    [0, 255], K (3, 3), E (3, 4) or (4, 4) world->camera, valid (N,) bool.
    Returns (H, W, 3) f32 uint8-quantised colors."""
    z, lin, ok = _project(points, K, E, H, W, valid)
    n_px = H * W
    # pass 1: nearest depth; z > 0 wherever ok, and positive floats order as
    # their bit patterns, so the uint32 minimum of the bits is the f32 minimum
    zbits = z.view(torch.int32).to(torch.int64) & SENTINEL
    zwin = scatter_min_u32(lin, torch.where(ok, zbits, SENTINEL), n_px + 1)
    # pass 2: lowest point id among the points at the winning depth
    at_front = ok & (zbits == zwin[lin])
    pid = torch.arange(points.shape[0], dtype=torch.int64, device=points.device)
    ibuf = scatter_min_u32(lin, torch.where(at_front, pid, SENTINEL), n_px + 1)[:n_px]
    return _paint(ibuf, ibuf != SENTINEL, colors, bg, (H, W, 3))


def project_points_zbuffer_sorted(points: torch.Tensor, colors: torch.Tensor, K: torch.Tensor,
                                  E: torch.Tensor, H: int, W: int,
                                  valid: Optional[torch.Tensor] = None,
                                  bg: Tuple[float, float, float] = (0.0, 0.0, 0.0)
                                  ) -> torch.Tensor:
    """Scatter-free twin of :func:`project_points_zbuffer`, same output:
    sort the points by (pixel, depth, id) and binary-search each pixel's
    first entry."""
    z, lin, ok = _project(points, K, E, H, W, valid)
    n_px = H * W
    n = points.shape[0]
    zkey = torch.where(ok, z, torch.inf).view(torch.int32).to(torch.int64) & SENTINEL
    # (pixel, depth bits) in one int64; a stable sort keeps ids ascending
    # among ties
    _, order = torch.sort(lin * (1 << 32) + zkey, stable=True)
    lin_s = lin[order]
    pixels = torch.arange(n_px, dtype=lin_s.dtype, device=lin_s.device)
    first = torch.searchsorted(lin_s, pixels)
    at = torch.clamp(first, max=n - 1)
    hit = (lin_s[at] == pixels) & (first < n)
    return _paint(order[at], hit, colors, bg, (H, W, 3))


def packed_keys(points: torch.Tensor, intrinsics: torch.Tensor, extrinsics: torch.Tensor,
                H: int, W: int, valid: Optional[torch.Tensor] = None):
    """The packed z-buffer's update stream: (lin (T, N) flat slots over T
    canvases of H*W + 1, key (T, N) int64 uint32 values, SENTINEL where the
    point misses the view, pid_bits)."""
    T = intrinsics.shape[0]
    n = points.shape[0]
    n_px = H * W
    if n >= _PACKED_MAX_POINTS:
        raise ValueError(
            f"packed z-buffer supports < {_PACKED_MAX_POINTS} points (got {n}): the id "
            f"field would leave too few depth bits; use zbuffer_impl='scatter'")
    pid_bits = max(22, (max(n, 2) - 1).bit_length())
    zq_top = float((1 << (32 - pid_bits)) - 2)  # max quantised depth (sentinel-safe)

    R = extrinsics[:, :3, :3].float()
    t = extrinsics[:, :3, 3].float()
    pc_cam = torch.einsum("nd,tkd->tnk", points.float(), R) + t[:, None, :]
    pc_proj = torch.einsum("tnk,tmk->tnm", pc_cam, intrinsics.float())
    z = pc_proj[..., 2]
    u = _to_pixel(pc_proj[..., 0] / (z + 1e-8))
    v = _to_pixel(pc_proj[..., 1] / (z + 1e-8))
    ok = (u >= 0) & (u < W) & (v >= 0) & (v < H) & (z > 0)
    if valid is not None:
        ok = ok & valid[None, :]

    # per-view depth range for the quantisation (masked; degenerate-safe)
    zmin = torch.where(ok, z, torch.inf).amin(dim=1, keepdim=True)
    zmax = torch.where(ok, z, -torch.inf).amax(dim=1, keepdim=True)
    scale = zq_top / torch.clamp(zmax - zmin, min=1e-9)
    zq = torch.nan_to_num(torch.clamp((z - zmin) * scale, 0.0, zq_top), nan=0.0).to(torch.int64)
    pid = torch.arange(n, dtype=torch.int64, device=points.device)
    key = torch.where(ok, (zq << pid_bits) | pid, SENTINEL)
    view_base = torch.arange(T, dtype=torch.int64, device=points.device)[:, None] * (n_px + 1)
    lin = view_base + torch.where(ok, v * W + u, n_px)
    return lin, key, pid_bits


def reproject_views_packed(points: torch.Tensor, colors: torch.Tensor,
                           intrinsics: torch.Tensor, extrinsics: torch.Tensor, H: int, W: int,
                           valid: Optional[torch.Tensor] = None,
                           bg: Tuple[float, float, float] = (0.0, 0.0, 0.0)) -> torch.Tensor:
    """All T views in one scatter-min over a packed key (``projection.py:167-278``).

    key = (depth quantised to zq_bits within the view's depth range) <<
    pid_bits | point id, pid_bits = max(22, bits(n - 1)), so min(key) is the
    nearest quantised depth with the lowest id among quantisation ties.
    Clouds of n >= 2**24 points would leave fewer than 8 depth bits and
    raise. Returns (T, H, W, 3).
    """
    T = intrinsics.shape[0]
    n_px = H * W
    lin, key, pid_bits = packed_keys(points, intrinsics, extrinsics, H, W, valid)
    buf = scatter_min_u32(lin.reshape(-1), key.reshape(-1), T * (n_px + 1))
    win = buf.reshape(T, n_px + 1)[:, :n_px]
    return _paint(win & ((1 << pid_bits) - 1), win != SENTINEL, colors, bg, (T, H, W, 3))


def batch_reproject(points: torch.Tensor, colors: torch.Tensor, intrinsics: torch.Tensor,
                    extrinsics: torch.Tensor, H: int, W: int,
                    valid: Optional[torch.Tensor] = None, zbuffer_impl: str = "scatter",
                    unit_colors: Optional[bool] = None) -> torch.Tensor:
    """Reproject a cloud (N, 3) with colors (N, 3) into T cameras
    (intrinsics (T, 3, 3), extrinsics (T, 3|4, 4)).

    zbuffer_impl: "scatter" (exact), "sorted" (exact, scatter-free) or
    "packed" (one scatter for all views; clouds of >= 2**24 points fall back
    to "scatter" with a warning). unit_colors: True = colors in [0, 1],
    False = [0, 255], None = detect by the maximum.

    Returns (T, 3, H, W) f32 frames in [-1, 1].
    """
    if zbuffer_impl not in ("scatter", "sorted", "packed"):
        raise ValueError(f"unknown zbuffer_impl {zbuffer_impl!r}")
    if unit_colors is None:
        colors = torch.where(colors.max() <= 1.0, colors * 255.0, colors)
    elif unit_colors:
        colors = colors * 255.0
    if zbuffer_impl == "packed" and points.shape[0] >= _PACKED_MAX_POINTS:
        warnings.warn(f"packed z-buffer supports < {_PACKED_MAX_POINTS} points "
                      f"(got {points.shape[0]}); falling back to exact scatter")
        zbuffer_impl = "scatter"
    if zbuffer_impl == "packed":
        render = reproject_views_packed(points, colors, intrinsics, extrinsics, H, W, valid)
    else:
        one_view = (project_points_zbuffer_sorted if zbuffer_impl == "sorted"
                    else project_points_zbuffer)
        # one view at a time: the per-view projection intermediates are
        # O(N_points), as the JAX package's lax.map over views
        render = torch.stack([one_view(points, colors, K, E, H, W, valid)
                              for K, E in zip(intrinsics, extrinsics)])
    return (render.permute(0, 3, 1, 2) / 255.0) * 2.0 - 1.0

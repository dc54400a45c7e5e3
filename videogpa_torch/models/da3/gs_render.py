"""3D Gaussian splatting renderer and camera trajectory helpers
(``videogpa_tpu/models/da3/gs_render.py``).

The reference's ``model/utils/gs_renderer.py``: ``render_3dgs`` (:44, which
calls gsplat's ``rasterization``) and ``run_renderer_in_chunk_w_trj_mode``
(:156, the trajectory modes). The JAX package renders with a fixed budget of
gaussians a tile, in plain XLA operations; this is the same algorithm in
plain PyTorch, differentiable end to end:

1. project every gaussian once (EWA: camera transform, perspective Jacobian
   with gsplat's 1.3x frustum clamp, 2D covariance + 0.3 px blur, 3-sigma
   radius);
2. for each 16 x 16 tile take the ``max_per_tile`` nearest gaussians whose
   bounding box overlaps it, equal depths lowest index first (``lax.top_k``'s
   order: ``torch.topk`` promises none, so the selection runs on int64 keys,
   the depth's order-preserving bits above the index);
3. alpha-composite front to back with a closed-form exclusive-cumsum
   transmittance.

A full scene is N = 10 x 518^2 = 2.68 M gaussians and 33 x 33 tiles a view,
so the per-tile overlap test over all N is never built: the renderer goes a
row of tiles at a time, over the gaussians whose box meets that row (plus the
first ``max_per_tile`` indices, which hold every pick a tile with fewer live
gaussians than its budget makes), as ``lax.map(..., batch_size=tiles_x)``
goes a row at a time.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from videogpa_torch.device import resolve_device
from videogpa_torch.geometry.rotation import mat_to_quat, quat_to_mat
from videogpa_torch.geometry.transforms import affine_inverse
from videogpa_torch.models.da3.gaussians import Gaussians

_SH_C0 = 0.28209479177387814
_TILE = 16
_INF_ORDER = 0x7F800000  # the order bits of +inf: a gaussian a tile does not take


def _quat_to_rotmat_wxyz(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def _project_gaussians(means, scales, quats, viewmat, fx, fy, cx, cy, W, H, near=0.01):
    """EWA projection of N gaussians for one camera. Returns (xy (N, 2)
    pixels, depth (N,), conic (N, 3), radius (N,), valid (N,))."""
    R, t = viewmat[:3, :3], viewmat[:3, 3]
    p_cam = means @ R.T + t
    z = p_cam[:, 2]
    valid = z > near
    zc = torch.clamp(z, min=near)
    xy = torch.stack([p_cam[:, 0] / zc * fx + cx, p_cam[:, 1] / zc * fy + cy], -1)

    # 3D covariance in the world: M = R_q diag(s); Sigma = M M^T
    M = _quat_to_rotmat_wxyz(quats) * scales[:, None, :]
    sigma_w = M @ M.transpose(-1, -2)
    sigma_c = torch.einsum("ij,njk,lk->nil", R, sigma_w, R)

    # perspective Jacobian (gsplat's convention, with the 1.3x frustum clamp)
    lim_x = 1.3 * (0.5 * W / fx)
    lim_y = 1.3 * (0.5 * H / fy)
    tx = torch.maximum(torch.minimum(p_cam[:, 0] / zc, lim_x), -lim_x) * zc
    ty = torch.maximum(torch.minimum(p_cam[:, 1] / zc, lim_y), -lim_y) * zc
    zero = torch.zeros_like(zc)
    J = torch.stack([torch.stack([fx / zc, zero, -fx * tx / (zc * zc)], -1),
                     torch.stack([zero, fy / zc, -fy * ty / (zc * zc)], -1)], dim=-2)
    cov2d = torch.einsum("nij,njk,nlk->nil", J, sigma_c, J)
    cov2d = cov2d + 0.3 * torch.eye(2, dtype=cov2d.dtype, device=cov2d.device)  # low-pass blur

    det = torch.clamp(cov2d[:, 0, 0] * cov2d[:, 1, 1] - cov2d[:, 0, 1] ** 2, min=1e-10)
    conic = torch.stack([cov2d[:, 1, 1] / det, -cov2d[:, 0, 1] / det, cov2d[:, 0, 0] / det], -1)
    mid = 0.5 * (cov2d[:, 0, 0] + cov2d[:, 1, 1])
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam1))
    return xy, z, conic, radius, valid


def _order_keys(depth: torch.Tensor) -> torch.Tensor:
    """f32 depths -> int64 keys ordered as (depth, index): the float's bits
    made monotone as a signed int32, above the index."""
    bits = depth.contiguous().view(torch.int32)
    order = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).long()
    return (order << 32) | torch.arange(depth.numel(), device=depth.device)


def _render_one_view(means, scales, quats, opac, colors, viewmat, K, W, H, bg, max_per_tile):
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    xy, depth, conic, radius, valid = _project_gaussians(
        means, scales, quats, viewmat, fx, fy, cx, cy, W, H)
    tiles_x = (W + _TILE - 1) // _TILE
    tiles_y = (H + _TILE - 1) // _TILE
    dev, dt = means.device, means.dtype
    N = means.shape[0]
    with torch.no_grad():
        # gaussian boxes in tile units; the keys decide the picks only
        g_x0, g_x1 = (xy[:, 0] - radius) / _TILE, (xy[:, 0] + radius) / _TILE
        g_y0, g_y1 = (xy[:, 1] - radius) / _TILE, (xy[:, 1] + radius) / _TILE
        taken = valid & (radius > 0)
        key = _order_keys(torch.where(taken, depth.detach(), torch.inf))
        inf_key = (torch.tensor(_INF_ORDER, device=dev) << 32) | torch.arange(N, device=dev)
        first = torch.arange(N, device=dev) < max_per_tile
    tile_x = torch.arange(tiles_x, device=dev)[:, None]
    offs = torch.arange(_TILE, device=dev, dtype=dt) + 0.5
    colors_rows, depth_rows = [], []
    for ty_i in range(tiles_y):
        with torch.no_grad():
            cand = torch.nonzero(first | (taken & (g_y1 >= ty_i) & (g_y0 <= ty_i + 1)))[:, 0]
            overlap = ((g_x1[cand] >= tile_x) & (g_x0[cand] <= tile_x + 1)
                       & (g_y1[cand] >= ty_i) & (g_y0[cand] <= ty_i + 1))  # (tiles_x, C)
            k = torch.where(overlap, key[cand], inf_key[cand])
            sel = torch.topk(k, max_per_tile, dim=1, largest=False, sorted=True).values
            idx = sel & 0xFFFFFFFF  # (tiles_x, M), nearest first
            live = (sel >> 32) != _INF_ORDER
        t_xy, t_conic, t_z = xy[idx], conic[idx], depth[idx]
        t_opac = opac[idx] * live
        t_col = colors[idx]  # (tiles_x, M, 3)

        # pixel centres of each tile of the row, row-major within a tile
        px = (tile_x * _TILE + offs)[:, None, :].expand(tiles_x, _TILE, _TILE)
        py = (ty_i * _TILE + offs)[None, :, None].expand(tiles_x, _TILE, _TILE)
        pix = torch.stack([px, py], -1).reshape(tiles_x, 1, -1, 2)
        dxy = pix - t_xy[:, :, None]  # (tiles_x, M, P, 2)
        power = (-0.5 * (t_conic[..., 0:1] * dxy[..., 0] ** 2 + t_conic[..., 2:3] * dxy[..., 1] ** 2)
                 - t_conic[..., 1:2] * dxy[..., 0] * dxy[..., 1])
        alpha = torch.clamp(t_opac[..., None] * torch.exp(torch.clamp(power, max=0.0)), max=0.999)
        alpha = torch.where(alpha < 1.0 / 255.0, torch.zeros_like(alpha), alpha)

        # front-to-back compositing: w_i = a_i * prod_{j<i} (1 - a_j)
        log_t = torch.cumsum(torch.log1p(-alpha), dim=1)
        trans_excl = torch.exp(torch.cat([torch.zeros_like(log_t[:, :1]), log_t[:, :-1]], dim=1))
        w = alpha * trans_excl
        color = torch.einsum("tmp,tmc->tpc", w, t_col) + torch.exp(log_t[:, -1])[..., None] * bg
        colors_rows.append(color.reshape(tiles_x, _TILE, _TILE, 3).transpose(0, 1)
                           .reshape(_TILE, tiles_x * _TILE, 3))
        depth_rows.append(torch.einsum("tmp,tm->tp", w, t_z).reshape(tiles_x, _TILE, _TILE)
                          .transpose(0, 1).reshape(_TILE, tiles_x * _TILE))
    img = torch.cat(colors_rows)[:H, :W].permute(2, 0, 1)
    return img, torch.cat(depth_rows)[:H, :W]


def render_3dgs(extrinsics, intrinsics, image_shape: Tuple[int, int], gaussians: Gaussians,
                background_color=None, batch: int = 0, max_per_tile: int = 256,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """extrinsics (V, 4, 4) world->camera, intrinsics (V, 3, 3) NORMALISED
    (the reference's convention), the gaussians' SH degree-0 colours. Returns
    (colour (V, 3, H, W), depth (V, H, W)) as f32 tensors on ``device`` (the
    card unless the caller says "cpu")."""
    device = resolve_device(device)
    H, W = image_shape

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32).to(device)

    ext, K = f32(extrinsics), f32(intrinsics)
    V = ext.shape[0]
    max_per_tile = min(max_per_tile, gaussians.means.shape[1])
    K = K * torch.tensor([W, H, 1.0], device=device)[:, None]  # to pixels
    bg = torch.zeros((V, 3), device=device) if background_color is None else f32(
        background_color)
    sh = f32(gaussians.harmonics[batch])  # (N, 3, d_sh)
    colors = sh[..., 0] * _SH_C0 + 0.5  # SH0 -> RGB (gsplat's convention)
    g = tuple(f32(x[batch]) for x in (gaussians.means, gaussians.scales, gaussians.rotations,
                                      gaussians.opacities))
    views = [_render_one_view(*g, colors, ext[v], K[v], W, H, bg[v], max_per_tile)
             for v in range(V)]
    return torch.stack([c for c, _ in views]), torch.stack([d for _, d in views])


# ---------------------------------------------------------------------------
# camera trajectory helpers (host numpy; reference gs_renderer.py:156+ and
# its wander / dolly / stabilisation path utilities)
# ---------------------------------------------------------------------------

def _slerp(q0: np.ndarray, q1: np.ndarray, t: np.ndarray) -> np.ndarray:
    d = np.clip(np.sum(q0 * q1, -1), -1, 1)
    q1 = np.where(d[..., None] < 0, -q1, q1)
    d = np.abs(d)
    theta = np.arccos(np.clip(d, -1, 1))
    sin_t = np.sin(theta)
    w0 = np.where(sin_t > 1e-6, np.sin((1 - t) * theta) / np.maximum(sin_t, 1e-9), 1 - t)
    w1 = np.where(sin_t > 1e-6, np.sin(t * theta) / np.maximum(sin_t, 1e-9), t)
    q = w0[..., None] * q0 + w1[..., None] * q1
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _mat_to_quat_np(R: np.ndarray) -> np.ndarray:
    return mat_to_quat(torch.as_tensor(R, dtype=torch.float32)).numpy()


def _quat_to_mat_np(q: np.ndarray) -> np.ndarray:
    return quat_to_mat(torch.as_tensor(q, dtype=torch.float32)).numpy()


def _affine_inverse_np(A: np.ndarray) -> np.ndarray:
    return affine_inverse(torch.as_tensor(A, dtype=torch.float32)).numpy()


def interpolate_extrinsics(c2w0: np.ndarray, c2w1: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Slerp the rotation and lerp the translation between two c2w poses; t (T,)."""
    q0 = _mat_to_quat_np(c2w0[:3, :3])[None]
    q1 = _mat_to_quat_np(c2w1[:3, :3])[None]
    q = _slerp(np.repeat(q0, len(t), 0), np.repeat(q1, len(t), 0), t)
    R = _quat_to_mat_np(q)
    T = (1 - t)[:, None] * c2w0[:3, 3] + t[:, None] * c2w1[:3, 3]
    out = np.tile(np.eye(4, dtype=np.float64), (len(t), 1, 1))
    out[:, :3, :3] = R
    out[:, :3, 3] = T
    return out.astype(np.float32)


def interpolate_intrinsics(k0: np.ndarray, k1: np.ndarray, t: np.ndarray) -> np.ndarray:
    return ((1 - t)[:, None, None] * k0 + t[:, None, None] * k1).astype(np.float32)


def render_stabilization_path(c2ws: np.ndarray, k_size: int = 50) -> np.ndarray:
    """Moving-average smoothing of positions and quaternions (reflect-padded)."""
    V = c2ws.shape[0]
    k = min(k_size, V) | 1  # odd
    pad = k // 2
    idx = np.concatenate([np.arange(pad, 0, -1), np.arange(V), np.arange(V - 2, V - 2 - pad, -1)])
    idx = np.clip(idx, 0, V - 1)
    pos = c2ws[idx, :3, 3]
    quat = _mat_to_quat_np(c2ws[idx, :3, :3])
    # hemisphere-align the quaternions before averaging
    for i in range(1, len(quat)):
        if np.dot(quat[i], quat[i - 1]) < 0:
            quat[i] = -quat[i]
    kernel = np.ones(k) / k
    sm_pos = np.stack([np.convolve(pos[:, i], kernel, "valid") for i in range(3)], -1)
    sm_q = np.stack([np.convolve(quat[:, i], kernel, "valid") for i in range(4)], -1)
    sm_q = sm_q / np.linalg.norm(sm_q, axis=-1, keepdims=True)
    out = np.tile(np.eye(4, dtype=np.float64), (V, 1, 1))
    out[:, :3, :3] = _quat_to_mat_np(sm_q)
    out[:, :3, 3] = sm_pos
    return out.astype(np.float32)


def render_wander_path(c2w: np.ndarray, intr: np.ndarray, h: int, w: int, num_frames: int = 60,
                       max_disp: float = 24.0) -> Tuple[np.ndarray, np.ndarray]:
    """Elliptical camera sway around one pose (the reference's wander mode)."""
    fx = float(intr[0, 0] * w)
    max_trans = max_disp / fx
    out = []
    for i in range(num_frames):
        a = 2 * np.pi * i / num_frames
        delta = np.eye(4, dtype=np.float32)
        delta[:3, 3] = [max_trans * np.sin(a), max_trans * np.cos(a) / 3.0,
                        max_trans * np.cos(a) / 3.0]
        out.append(c2w @ delta)
    return np.stack(out), np.tile(intr, (num_frames, 1, 1)).astype(np.float32)


def render_dolly_zoom_path(c2w: np.ndarray, intr: np.ndarray, h: int, w: int,
                           num_frames: int = 60, max_disp: float = 48.0
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Dolly zoom: move along +z while the focal length widens to compensate."""
    fx = float(intr[0, 0] * w)
    max_trans = max_disp / fx
    outs, intrs = [], []
    for i in range(num_frames):
        a = 2 * np.pi * i / num_frames
        delta = np.eye(4, dtype=np.float32)
        delta[2, 3] = max_trans * (1 - np.cos(a)) / 2.0
        k = intr.copy()
        zoom = 1.0 + 0.5 * (1 - np.cos(a)) / 2.0
        k[0, 0] *= zoom
        k[1, 1] *= zoom
        outs.append(c2w @ delta)
        intrs.append(k)
    return np.stack(outs), np.stack(intrs).astype(np.float32)


def run_renderer_chunked(gaussians: Gaussians, extrinsics: np.ndarray, intrinsics: np.ndarray,
                         image_shape: Tuple[int, int],
                         input_shape: Optional[Tuple[int, int]] = None,
                         trj_mode: str = "smooth", chunk_size: int = 8, max_per_tile: int = 256,
                         device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Render a camera trajectory derived from the input poses: extrinsics
    (V, 3 or 4, 4) world->camera, intrinsics (V, 3, 3) in pixels. trj_mode:
    original | smooth | interpolate | interpolate_smooth | wander |
    dolly_zoom (the reference's gs_renderer.py:161-175 modes without the
    compound 'extend' / 'wobble_inter'). Returns numpy (colour (T, 3, H, W),
    depth (T, H, W)); the render runs on ``device``."""
    V = extrinsics.shape[0]
    if extrinsics.shape[-2] == 3:
        pad = np.tile(np.array([[0, 0, 0, 1.0]], np.float32), (V, 1, 1))
        extrinsics = np.concatenate([extrinsics, pad], axis=1)
    in_h, in_w = input_shape if input_shape is not None else image_shape
    intr_n = intrinsics.astype(np.float32).copy()
    intr_n[:, 0, :] /= in_w
    intr_n[:, 1, :] /= in_h
    c2w = _affine_inverse_np(extrinsics)

    if trj_mode == "original":
        tgt_c2w, tgt_intr = c2w, intr_n
    elif trj_mode == "smooth":
        tgt_c2w, tgt_intr = render_stabilization_path(c2w), intr_n
    elif trj_mode in ("interpolate", "interpolate_smooth"):
        t = np.linspace(0, 1, 8, dtype=np.float32)
        t = (np.cos(np.pi * (t + 1)) + 1) / 2  # cosine easing (the reference's)
        cs, ks = [], []
        for i in range(V - 1):
            skip = 0 if i == 0 else 1
            cs.append(interpolate_extrinsics(c2w[i], c2w[i + 1], t)[skip:])
            ks.append(interpolate_intrinsics(intr_n[i], intr_n[i + 1], t)[skip:])
        tgt_c2w = np.concatenate(cs)
        tgt_intr = np.concatenate(ks)
        if trj_mode == "interpolate_smooth":
            tgt_c2w = render_stabilization_path(tgt_c2w)
    elif trj_mode == "wander":
        tgt_c2w, tgt_intr = render_wander_path(c2w[0], intr_n[0], in_h, in_w)
    elif trj_mode == "dolly_zoom":
        tgt_c2w, tgt_intr = render_dolly_zoom_path(c2w[0], intr_n[0], in_h, in_w)
    else:
        raise ValueError(f"unknown trj_mode {trj_mode!r}")

    w2c = _affine_inverse_np(tgt_c2w)
    colors, depths = [], []
    with torch.no_grad():
        for s0 in range(0, len(w2c), chunk_size):
            c, d = render_3dgs(w2c[s0:s0 + chunk_size], tgt_intr[s0:s0 + chunk_size],
                               image_shape, gaussians, max_per_tile=max_per_tile, device=device)
            colors.append(c.cpu().numpy())
            depths.append(d.cpu().numpy())
    return np.concatenate(colors), np.concatenate(depths)

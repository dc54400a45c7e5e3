"""VGGT's SfM pack (``videogpa_tpu/models/vggt/sfm.py``): OpenCV-style
distortion and its Newton undistortion, batched projection, COLMAP interop
over the port's ``models/da3/colmap_io.py`` dataclasses, and
``predict_tracks``, the reference's ``track_predict.py`` on the VGGT track
head or on the VGGSfM tracker.

The undistortion runs a Python loop that stops on the same iteration as
JAX's ``lax.while_loop``: at 100 steps or when the largest squared step of
the whole batch falls below ``max_step_norm`` (read on the host each step).
Query selection, frame ranking and the rolls of ``predict_tracks`` are the
JAX package's host numpy, copied.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from videogpa_torch.models.vggt.model import vggt_forward
from videogpa_torch.models.vggt.vggsfm_tracker import vggsfm_tracker_forward


# ---------------------------------------------------------------------------
# Distortion
# ---------------------------------------------------------------------------

def apply_distortion(params: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Radial / OpenCV distortion. params (B, k) with k in {1, 2, 4}; u, v
    (B, N) normalised coordinates. Returns the distorted (u, v)."""
    k = params.shape[1]
    u2, v2 = u * u, v * v
    r2 = u2 + v2
    if k == 1:
        radial = params[:, 0:1] * r2
        du, dv = u * radial, v * radial
    elif k == 2:
        radial = params[:, 0:1] * r2 + params[:, 1:2] * r2 * r2
        du, dv = u * radial, v * radial
    elif k == 4:
        k1, k2 = params[:, 0:1], params[:, 1:2]
        p1, p2 = params[:, 2:3], params[:, 3:4]
        uv = u * v
        radial = k1 * r2 + k2 * r2 * r2
        du = u * radial + 2 * p1 * uv + p2 * (r2 + 2 * u2)
        dv = v * radial + 2 * p2 * uv + p1 * (r2 + 2 * v2)
    else:
        raise ValueError(f"unsupported number of distortion parameters: {k}")
    return u + du, v + dv


def iterative_undistortion(params: torch.Tensor, tracks_normalized: torch.Tensor,
                           max_iterations: int = 100, max_step_norm: float = 1e-10,
                           rel_step_size: float = 1e-6) -> torch.Tensor:
    """Newton undistortion with a numeric Jacobian (COLMAP's scheme).
    tracks_normalized (B, N, 2) -> undistorted (B, N, 2)."""
    orig_u, orig_v = tracks_normalized[..., 0], tracks_normalized[..., 1]
    eps = torch.finfo(orig_u.dtype).eps
    u, v = orig_u, orig_v
    moving, it = True, 0
    while it < max_iterations and moving:
        u_d, v_d = apply_distortion(params, u, v)
        dx, dy = orig_u - u_d, orig_v - v_d
        su = torch.clamp(u.abs() * rel_step_size, min=eps)
        sv = torch.clamp(v.abs() * rel_step_size, min=eps)
        up, um = apply_distortion(params, u + su, v), apply_distortion(params, u - su, v)
        vp, vm = apply_distortion(params, u, v + sv), apply_distortion(params, u, v - sv)
        J00 = (up[0] - um[0]) / (2 * su) + 1
        J01 = (vp[0] - vm[0]) / (2 * sv)
        J10 = (up[1] - um[1]) / (2 * su)
        J11 = (vp[1] - vm[1]) / (2 * sv) + 1
        det = J00 * J11 - J01 * J10
        det = torch.where(det.abs() < 1e-32, torch.full_like(det, 1e-32), det)
        delta_u = (J11 * dx - J01 * dy) / det
        delta_v = (J00 * dy - J10 * dx) / det
        # compared in the tracks' dtype, as the JAX loop's condition
        moving = bool((delta_u ** 2 + delta_v ** 2).max() >= max_step_norm)
        u, v, it = u + delta_u, v + delta_v, it + 1
    return torch.stack([u, v], dim=-1)


# ---------------------------------------------------------------------------
# Projection
# ---------------------------------------------------------------------------

def img_from_cam(intrinsics: torch.Tensor, points_cam: torch.Tensor,
                 extra_params: Optional[torch.Tensor] = None,
                 default: float = 0.0) -> torch.Tensor:
    """K (B, 3, 3) x camera-space points (B, 3, N) -> pixels (B, N, 2), with
    optional distortion of the normalised coordinates."""
    uvw = points_cam / points_cam[:, 2:3, :]
    uv = uvw[:, :2, :]
    if extra_params is not None:
        uu, vv = apply_distortion(extra_params, uv[:, 0], uv[:, 1])
        uv = torch.stack([uu, vv], dim=1)
    pts_h = torch.cat([uv, torch.ones_like(uv[:, :1])], dim=1)
    pts2d = torch.einsum("bij,bjn->bin", intrinsics, pts_h)[:, :2]
    return torch.nan_to_num(pts2d, nan=default).transpose(1, 2)


def project_3d_points(points3d: torch.Tensor, extrinsics: torch.Tensor,
                      intrinsics: Optional[torch.Tensor] = None,
                      extra_params: Optional[torch.Tensor] = None, default: float = 0.0,
                      only_points_cam: bool = False):
    """World points (N, 3) through B cameras (B, 3, 4 [R|t]) -> (points2d
    (B, N, 2) or None, points_cam (B, 3, N))."""
    N = points3d.shape[0]
    h = torch.cat([points3d, torch.ones((N, 1), dtype=points3d.dtype,
                                        device=points3d.device)], dim=1)
    points_cam = torch.einsum("bij,nj->bin", extrinsics, h)
    if only_points_cam:
        return None, points_cam
    if intrinsics is None:
        raise ValueError("intrinsics required unless only_points_cam=True")
    return img_from_cam(intrinsics, points_cam, extra_params, default), points_cam


# ---------------------------------------------------------------------------
# COLMAP interop
# ---------------------------------------------------------------------------

def batch_matrix_to_colmap(points3d: np.ndarray, extrinsics: np.ndarray,
                           intrinsics: np.ndarray, tracks: np.ndarray,
                           valid_mask: Optional[np.ndarray] = None,
                           image_size: Tuple[int, int] = (518, 518),
                           shared_camera: bool = False):
    """(P, 3) points + (B, 3, 4) poses + (B, 3, 3) K + (B, P, 2) track pixels
    -> (cameras, images, points3D) dicts of ``colmap_io`` dataclasses.
    ``valid_mask`` (B, P) picks the observations that enter each image's 2D
    points and the points' tracks. The rotations go to quaternions in f32,
    as JAX's ``mat_to_quat`` takes them."""
    from videogpa_torch.geometry import mat_to_quat
    from videogpa_torch.models.da3.colmap_io import ColmapCamera, ColmapImage, ColmapPoint3D

    B, P = tracks.shape[:2]
    W, H = image_size
    if valid_mask is None:
        valid_mask = np.ones((B, P), bool)

    cameras: Dict[int, ColmapCamera] = {}
    for b in range(B):
        cam_id = 1 if shared_camera else b + 1
        if cam_id not in cameras:
            K = intrinsics[b]
            cameras[cam_id] = ColmapCamera(
                id=cam_id, model="PINHOLE", width=W, height=H,
                params=np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]], np.float64))

    point_tracks: Dict[int, List[Tuple[int, int]]] = {p: [] for p in range(P)}
    images: Dict[int, ColmapImage] = {}
    for b in range(B):
        obs_idx = np.nonzero(valid_mask[b])[0]
        for row, p in enumerate(obs_idx):
            point_tracks[int(p)].append((b + 1, row))
        rot = torch.from_numpy(np.asarray(extrinsics[b:b + 1, :3, :3], np.float32))
        q_xyzw = mat_to_quat(rot).numpy()[0]
        images[b + 1] = ColmapImage(
            id=b + 1, qvec=np.array([q_xyzw[3], q_xyzw[0], q_xyzw[1], q_xyzw[2]]),
            tvec=extrinsics[b, :3, 3].astype(np.float64),
            camera_id=1 if shared_camera else b + 1, name=f"frame_{b:05d}.png",
            xys=tracks[b, obs_idx].astype(np.float64),
            point3D_ids=(obs_idx + 1).astype(np.int64))

    points3D: Dict[int, ColmapPoint3D] = {}
    for p in range(P):
        track = point_tracks[p]
        points3D[p + 1] = ColmapPoint3D(
            id=p + 1, xyz=points3d[p].astype(np.float64),
            rgb=np.array([128, 128, 128], np.uint8), error=0.0,
            image_ids=np.array([t[0] for t in track], np.int64),
            point2D_idxs=np.array([t[1] for t in track], np.int64))
    return cameras, images, points3D


def colmap_to_batch_matrix(cameras, images, points3D):
    """Inverse of :func:`batch_matrix_to_colmap`: -> (points3d (P, 3),
    extrinsics (B, 3, 4), intrinsics (B, 3, 3)), f32."""
    img_ids = sorted(images)
    extr = np.stack([images[i].extrinsic[:3] for i in img_ids])
    intr = np.stack([cameras[images[i].camera_id].K for i in img_ids])
    pts = (np.stack([points3D[p].xyz for p in sorted(points3D)]) if points3D
           else np.zeros((0, 3)))
    return pts.astype(np.float32), extr.astype(np.float32), intr.astype(np.float32)


# ---------------------------------------------------------------------------
# Track prediction
# ---------------------------------------------------------------------------

def rank_query_frames(cls_feats: np.ndarray, query_frame_num: int) -> List[int]:
    """Frames ranked for querying by mean cosine similarity to all frames,
    the most similar first (``vggsfm_utils.generate_rank_by_dino``'s rule)."""
    f = cls_feats / (np.linalg.norm(cls_feats, axis=-1, keepdims=True) + 1e-8)
    sim = f @ f.T
    order = np.argsort(-sim.mean(axis=1))
    return [int(i) for i in order[:query_frame_num]]


def _host(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


@torch.no_grad()
def predict_tracks(model, images: np.ndarray, conf: Optional[np.ndarray] = None,
                   max_query_pts: int = 256, query_frame_num: int = 2, iters: int = 4,
                   track_kwargs: Optional[dict] = None, tracker=None):
    """Track query keypoints from the ranked query frames across all images,
    on the model's device.

    Args:
        model: a ``VGGT`` with its track head.
        images: (S, 3, H, W) in [0, 1].
        conf: optional (S, H, W) confidence: the query points are its top
            ``max_query_pts`` pixels of each query frame (else a uniform
            grid), and its frames' means rank them (else depth_conf's).
        iters: taken as the JAX function takes it; the head's iterations
            come from ``track_kwargs``.
        tracker: an optional ``VGGSfMTracker``; when given it tracks instead
            of the VGGT head (the reference's ``track_predict.py``), and its
            vis doubles as conf.

    Returns:
        dict with tracks (Q, S, N, 2), vis (Q, S, N), conf (Q, S, N) and
        query_frames (the ranked frame indices), Q query frames.
    """
    S, _, H, W = images.shape
    device = next(model.parameters()).device
    x = torch.as_tensor(np.asarray(images, np.float32), device=device)[None]

    out = vggt_forward(model, x, query_points=None)
    # a frame signature: the depth confidence when no conf is given
    sig = _host(out["depth_conf"][0].reshape(S, -1)) if conf is None else conf.reshape(S, -1)
    query_frames = rank_query_frames(sig, query_frame_num)

    all_tracks, all_vis, all_conf = [], [], []
    for qf in query_frames:
        if conf is not None:
            idx = np.argsort(-conf[qf].reshape(-1))[:max_query_pts]
        else:
            idx = np.linspace(0, H * W - 1, max_query_pts).astype(int)
        qy = (idx // W).astype(np.float32)
        qx = (idx % W).astype(np.float32)
        qpts = torch.as_tensor(np.stack([qx, qy], axis=1), device=device)[None]
        # the query frame first (the head tracks from frame 0), rolled back after
        order = np.roll(np.arange(S), -qf)
        xq = x[:, torch.as_tensor(order, device=device)]
        inv = np.argsort(order)
        if tracker is not None:
            fine, _, vis, _ = vggsfm_tracker_forward(tracker, xq, qpts, **(track_kwargs or {}))
            track, conf_q = fine, vis
        else:
            res = vggt_forward(model, xq, query_points=qpts, track_kwargs=track_kwargs)
            track, vis, conf_q = res["track"], res["vis"], res["conf"]
        all_tracks.append(_host(track[0])[inv])
        all_vis.append(_host(vis[0])[inv])
        all_conf.append(_host(conf_q[0])[inv])

    return {"tracks": np.stack(all_tracks), "vis": np.stack(all_vis),
            "conf": np.stack(all_conf), "query_frames": query_frames}

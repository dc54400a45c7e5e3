"""Trajectory alignment: Umeyama Sim(3), optionally RANSAC-robust
(``videogpa_tpu/geometry/alignment.py``, host numpy, copied).

Parity target: reference ``depth_anything_3/utils/pose_align.py:111-196`` —
align estimated camera trajectories to reference ones with a similarity
transform over camera centers; RANSAC variant subsamples poses, fits, counts
inliers by center distance, refits on the best inlier set.

Numpy (host-side) by design: trajectory alignment is a tiny O(S) problem that
runs once per clip.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def _to_44(ext: np.ndarray) -> np.ndarray:
    if ext.shape[-2] == 3:
        out = np.tile(np.eye(4), (len(ext), 1, 1))
        out[:, :3] = ext
        return out
    return ext


def _affine_inverse_np(A: np.ndarray) -> np.ndarray:
    R = A[..., :3, :3]
    t = A[..., :3, 3:]
    out = np.tile(np.eye(4), A.shape[:-2] + (1, 1))
    Rt = np.swapaxes(R, -1, -2)
    out[..., :3, :3] = Rt
    out[..., :3, 3:] = -Rt @ t
    return out


def umeyama_sim3(
    src: np.ndarray, dst: np.ndarray, with_scale: bool = True
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity transform mapping src points onto dst.

    Args:
        src, dst: (N, 3) corresponding points.

    Returns:
        (R (3,3), t (3,), s) with dst ≈ s * R @ src + t.
    """
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (xs ** 2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12)) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def _apply_sim3_to_poses(poses: np.ndarray, R: np.ndarray, t: np.ndarray, s: float):
    out = poses.copy()
    out[:, :3, 3] = (s * (R @ poses[:, :3, 3].T)).T + t
    out[:, :3, :3] = np.einsum("ij,njk->nik", R, poses[:, :3, :3])
    return out


def align_poses_umeyama(
    ext_ref: np.ndarray,
    ext_est: np.ndarray,
    return_aligned: bool = False,
    ransac: bool = False,
    sub_n: Optional[int] = None,
    inlier_thresh: Optional[float] = None,
    ransac_max_iters: int = 10,
    random_state: Optional[int] = None,
):
    """Align estimated extrinsics (world->cam) to reference via Sim(3).

    Returns (R, t, s) and optionally the aligned world->cam extrinsics (4x4).
    """
    pose_ref = _affine_inverse_np(_to_44(np.asarray(ext_ref, np.float64)))
    pose_est = _affine_inverse_np(_to_44(np.asarray(ext_est, np.float64)))
    c_ref = pose_ref[:, :3, 3]
    c_est = pose_est[:, :3, 3]
    n = len(c_ref)

    if not ransac or n < 4:
        R, t, s = umeyama_sim3(c_est, c_ref)
    else:
        rng = np.random.default_rng(random_state)
        sub_n = sub_n or max(3, (n + 1) // 2)
        R0, t0, s0 = umeyama_sim3(c_est, c_ref)
        pre = (s0 * (R0 @ c_est.T)).T + t0
        d0 = np.linalg.norm(pre - c_ref, axis=1)
        thresh = inlier_thresh if inlier_thresh is not None else float(np.median(d0))
        best_inliers = d0 <= max(thresh, 1e-9)
        for _ in range(ransac_max_iters):
            idx = rng.choice(n, size=min(sub_n, n), replace=False)
            Ri, ti, si = umeyama_sim3(c_est[idx], c_ref[idx])
            aligned = (si * (Ri @ c_est.T)).T + ti
            inliers = np.linalg.norm(aligned - c_ref, axis=1) <= max(thresh, 1e-9)
            if inliers.sum() > best_inliers.sum():
                best_inliers = inliers
        if best_inliers.sum() >= 3:
            R, t, s = umeyama_sim3(c_est[best_inliers], c_ref[best_inliers])
        else:
            R, t, s = R0, t0, s0

    if return_aligned:
        aligned_poses = _apply_sim3_to_poses(pose_est, R, t, s)
        return R, t, s, _affine_inverse_np(aligned_poses)
    return R, t, s

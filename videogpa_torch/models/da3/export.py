"""DA3 prediction export pack (``videogpa_tpu/models/da3/export.py``): npz,
mini_npz, ply, glb, feat_vis, colmap, depth_vis, gs_ply and gs_video.

The reference's export dispatch (``depth_anything_3/utils/export/__init__.py:
18-63``) on numpy and the standard library (no trimesh or plyfile). World
points and the COLMAP quaternions come from the port's ``unproject_depth``,
``closed_form_inverse_se3`` and ``mat_to_quat`` on the host in f32; gs_video
renders on ``device`` (the card unless the caller says "cpu"). depth_vis
needs OpenCV and matplotlib, feat_vis writes its PNGs with PIL where it is
installed, gs_video writes its mp4 with ``data.video_io.write_video``.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

from videogpa_torch.geometry.rotation import mat_to_quat
from videogpa_torch.geometry.transforms import closed_form_inverse_se3, unproject_depth
from videogpa_torch.reward.pointcloud import save_ply

EXPORTERS = {}


def register(name):
    def deco(fn):
        EXPORTERS[name] = fn
        return fn

    return deco


def export(prediction, export_format: str, out_dir: str, **kwargs) -> str:
    """Write a DA3Prediction in ``export_format`` under ``out_dir``; returns
    the path written."""
    if export_format not in EXPORTERS:
        raise ValueError(f"unknown export format {export_format!r}; have {sorted(EXPORTERS)}")
    os.makedirs(out_dir, exist_ok=True)
    return EXPORTERS[export_format](prediction, out_dir, **kwargs)


def _world_points(prediction) -> np.ndarray:
    depth = torch.as_tensor(prediction.depth, dtype=torch.float32)[None, ..., None]
    intr = torch.as_tensor(prediction.intrinsics, dtype=torch.float32)[None]
    c2w = closed_form_inverse_se3(torch.as_tensor(prediction.extrinsics,
                                                  dtype=torch.float32))[None]
    return unproject_depth(depth, intr, c2w)[0].numpy()  # (S, H, W, 3)


def _colors(prediction) -> np.ndarray:
    imgs = prediction.processed_images
    if imgs.max() <= 1.0:
        imgs = imgs * 255.0
    return imgs


@register("npz")
def export_npz(prediction, out_dir: str, **_) -> str:
    path = os.path.join(out_dir, "prediction.npz")
    np.savez_compressed(path, depth=prediction.depth,
                        conf=prediction.conf if prediction.conf is not None else np.zeros(0),
                        extrinsics=prediction.extrinsics, intrinsics=prediction.intrinsics,
                        processed_images=prediction.processed_images.astype(np.uint8))
    return path


@register("mini_npz")
def export_mini_npz(prediction, out_dir: str, **_) -> str:
    path = os.path.join(out_dir, "prediction_mini.npz")
    np.savez_compressed(path, depth=prediction.depth.astype(np.float16),
                        extrinsics=prediction.extrinsics.astype(np.float32),
                        intrinsics=prediction.intrinsics.astype(np.float32))
    return path


@register("ply")
def export_ply(prediction, out_dir: str, conf_frac: float = 0.0, **_) -> str:
    pts = _world_points(prediction).reshape(-1, 3)
    cols = _colors(prediction).reshape(-1, 3)
    if prediction.conf is not None and conf_frac > 0:
        conf = prediction.conf.reshape(-1)
        keep = conf >= np.quantile(conf, conf_frac)
        pts, cols = pts[keep], cols[keep]
    path = os.path.join(out_dir, "pointcloud.ply")
    save_ply(pts, cols, path)
    return path


@register("glb")
def export_glb(prediction, out_dir: str, max_points: int = 500_000, **_) -> str:
    """Minimal binary glTF point cloud (POSITION + COLOR_0, mode POINTS)."""
    pts = _world_points(prediction).reshape(-1, 3).astype(np.float32)
    cols = (_colors(prediction).reshape(-1, 3) / 255.0).astype(np.float32)
    if len(pts) > max_points:
        idx = np.linspace(0, len(pts) - 1, max_points).astype(int)
        pts, cols = pts[idx], cols[idx]
    # glTF is y-up: flip y and z of the OpenCV frame
    pts = pts * np.array([1, -1, -1], np.float32)

    pos_bytes = pts.tobytes()
    col_bytes = cols.tobytes()
    bin_blob = pos_bytes + col_bytes
    gltf = {
        "asset": {"version": "2.0", "generator": "videogpa_torch"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "COLOR_0": 1}, "mode": 0}]}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": len(pts), "type": "VEC3",
             "min": pts.min(0).tolist(), "max": pts.max(0).tolist()},
            {"bufferView": 1, "componentType": 5126, "count": len(cols), "type": "VEC3"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": len(pos_bytes)},
            {"buffer": 0, "byteOffset": len(pos_bytes), "byteLength": len(col_bytes)},
        ],
        "buffers": [{"byteLength": len(bin_blob)}],
    }
    json_blob = json.dumps(gltf).encode()
    json_blob += b" " * (-len(json_blob) % 4)
    bin_blob += b"\x00" * (-len(bin_blob) % 4)
    path = os.path.join(out_dir, "scene.glb")
    with open(path, "wb") as f:
        total = 12 + 8 + len(json_blob) + 8 + len(bin_blob)
        f.write(struct.pack("<III", 0x46546C67, 2, total))
        f.write(struct.pack("<II", len(json_blob), 0x4E4F534A))
        f.write(json_blob)
        f.write(struct.pack("<II", len(bin_blob), 0x004E4942))
        f.write(bin_blob)
    return path


@register("feat_vis")
def export_feat_vis(prediction, out_dir: str, **_) -> str:
    """PCA feature visualisation (the reference's feat_vis / ``pca_utils.py``):
    the backbone's patch tokens projected on their top-3 principal
    components, each channel normalised to [0, 1] over the sequence, one RGB
    PNG a view (upsampled to the frame) and the PCA maps as .npz. Needs
    ``da3_inference(..., return_features=True)``."""
    if prediction.features is None:
        raise ValueError("prediction has no features — run da3_inference with "
                         "return_features=True for feat_vis export")
    d = os.path.join(out_dir, "feat_vis")
    os.makedirs(d, exist_ok=True)
    feats = prediction.features.astype(np.float32)  # (S, h, w, C)
    S, h, w, C = feats.shape
    flat = feats.reshape(-1, C)
    flat = flat - flat.mean(axis=0, keepdims=True)
    _, _, vt = np.linalg.svd(flat, full_matrices=False)  # top-3 directions over all views
    proj = flat @ vt[:3].T
    lo = np.percentile(proj, 1, axis=0)
    hi = np.percentile(proj, 99, axis=0)
    rgb = np.clip((proj - lo) / np.maximum(hi - lo, 1e-8), 0, 1).reshape(S, h, w, 3)
    np.savez_compressed(os.path.join(d, "feat_pca.npz"), pca=rgb)
    try:
        from PIL import Image

        H, W = prediction.processed_images.shape[1:3]
        for i in range(S):
            img = Image.fromarray((rgb[i] * 255).astype(np.uint8)).resize((W, H), Image.NEAREST)
            img.save(os.path.join(d, f"feat_{i:04d}.png"))
    except ImportError:
        pass  # the npz alone is still a valid export
    return d


@register("colmap")
def export_colmap(prediction, out_dir: str, **_) -> str:
    """COLMAP text model (cameras.txt / images.txt / points3D.txt)."""
    d = os.path.join(out_dir, "colmap")
    os.makedirs(d, exist_ok=True)
    S, H, W = prediction.depth.shape
    with open(os.path.join(d, "cameras.txt"), "w") as f:
        f.write("# Camera list: CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]\n")
        for i, K in enumerate(prediction.intrinsics):
            f.write(f"{i + 1} PINHOLE {W} {H} {K[0, 0]:.6f} {K[1, 1]:.6f} "
                    f"{K[0, 2]:.6f} {K[1, 2]:.6f}\n")
    with open(os.path.join(d, "images.txt"), "w") as f:
        f.write("# IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME\n")
        for i, E in enumerate(prediction.extrinsics):
            q = mat_to_quat(torch.as_tensor(E[:3, :3], dtype=torch.float32)[None])[0].numpy()
            t = E[:3, 3]  # q is xyzw
            f.write(f"{i + 1} {q[3]:.8f} {q[0]:.8f} {q[1]:.8f} {q[2]:.8f} "
                    f"{t[0]:.8f} {t[1]:.8f} {t[2]:.8f} {i + 1} frame_{i:05d}.png\n\n")
    with open(os.path.join(d, "points3D.txt"), "w") as f:
        f.write("# POINT3D_ID X Y Z R G B ERROR TRACK[]\n")
    return d


@register("depth_vis")
def export_depth_vis(prediction, out_dir: str, **_) -> str:
    """Side-by-side [image | Spectral-coloured inverse depth] jpgs, the
    reference's layout (``utils/export/depth_vis.py:25-41``)."""
    import cv2

    from videogpa_torch.models.da3.visualize import visualize_depth

    d = os.path.join(out_dir, "depth_vis")
    os.makedirs(d, exist_ok=True)
    for i, depth in enumerate(prediction.depth):
        vis = visualize_depth(np.asarray(depth))
        img = np.clip(prediction.processed_images[i], 0, 255).astype(np.uint8)
        pair = np.concatenate([img, vis], axis=1)
        cv2.imwrite(os.path.join(d, f"{i:04d}.jpg"), cv2.cvtColor(pair, cv2.COLOR_RGB2BGR),
                    [cv2.IMWRITE_JPEG_QUALITY, 95])
    return d


def _fallback_gaussians(prediction):
    """Depth-anchored isotropic gaussians from the point map (no GS branch)."""
    from videogpa_torch.models.da3.gaussians import Gaussians

    pts = _world_points(prediction).reshape(1, -1, 3)
    cols = _colors(prediction).reshape(1, -1, 3).astype(np.float32) / 255.0
    n = pts.shape[1]
    sh0 = ((cols - 0.5) / 0.28209479177387814)[..., None]  # flat colour: (c - 0.5) / C0
    depth = prediction.depth.reshape(1, -1)
    fx = float(np.mean(prediction.intrinsics[:, 0, 0]))
    iso = np.repeat((depth / fx)[..., None], 3, axis=-1)
    return Gaussians(means=pts, harmonics=sh0, opacities=np.full((1, n), 0.8, np.float32),
                     scales=iso.astype(np.float32),
                     rotations=np.tile(np.array([1.0, 0, 0, 0], np.float32), (1, n, 1)))


@register("gs_ply")
def export_gs_ply(prediction, out_dir: str, **_) -> str:
    """3DGS PLY of ``prediction.gaussians`` (the reference's
    ``utils/export/gs.py``); without the Gaussian branch, depth-anchored
    gaussians from the point map (colour-only splats)."""
    from videogpa_torch.models.da3.gaussians import save_gs_ply

    g = getattr(prediction, "gaussians", None)
    if g is None:
        g = _fallback_gaussians(prediction)
    path = os.path.join(out_dir, "gaussians.ply")
    os.makedirs(out_dir, exist_ok=True)
    save_gs_ply(g, path)
    return path


@register("gs_video")
def export_gs_video(prediction, out_dir: str, trj_mode: str = "smooth", fps: int = 24,
                    max_per_tile: int = 256, device=None, **_) -> str:
    """Render the gaussians along a derived camera trajectory to mp4 (the
    reference's gs_video: gsplat render + ffmpeg; here ``gs_render.py`` on
    ``device`` and ``write_video``)."""
    from videogpa_torch.data import video_io
    from videogpa_torch.models.da3.gs_render import run_renderer_chunked

    g = getattr(prediction, "gaussians", None)
    if g is None:
        g = _fallback_gaussians(prediction)
    H, W = prediction.depth.shape[-2:]
    color, _ = run_renderer_chunked(g, prediction.extrinsics, prediction.intrinsics, (H, W),
                                    trj_mode=trj_mode, max_per_tile=max_per_tile, device=device)
    frames = (np.clip(color, 0, 1).transpose(0, 2, 3, 1) * 255).astype(np.uint8)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"gs_{trj_mode}.mp4")
    video_io.write_video(path, frames, fps=fps)
    return path

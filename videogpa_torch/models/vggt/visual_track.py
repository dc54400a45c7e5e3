"""Track visualisation: tracked points drawn coloured by their first visible
position, a copy of ``videogpa_tpu/models/vggt/visual_track.py`` (the
reference's ``vggt/utils/visual_track.py``: ``color_from_xy``,
``get_track_colors_by_position``, ``visualize_tracks_on_images``). Host
numpy and OpenCV (an HSV wheel instead of matplotlib); ``cv2`` is imported
at the first call, so the module imports where OpenCV is absent.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def color_from_xy(x: float, y: float, W: int, H: int) -> tuple:
    """Map a normalised first-visible position to an HSV-wheel RGB colour."""
    import cv2

    v = (x / max(W, 1) + y / max(H, 1)) / 2.0
    hsv = np.array([[[int(np.clip(v, 0, 1) * 179), 255, 255]]], np.uint8)
    rgb = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)[0, 0]
    return int(rgb[0]), int(rgb[1]), int(rgb[2])


def get_track_colors_by_position(
    tracks: np.ndarray,  # (S, N, 2)
    vis_mask: Optional[np.ndarray],  # (S, N) bool
    image_width: int,
    image_height: int,
) -> np.ndarray:
    """(N, 3) uint8 colours keyed by each track's first visible position."""
    S, N, _ = tracks.shape
    if vis_mask is None:
        vis_mask = np.ones((S, N), bool)
    colors = np.zeros((N, 3), np.uint8)
    for i in range(N):
        vis = np.nonzero(vis_mask[:, i])[0]
        s0 = int(vis[0]) if len(vis) else 0
        x, y = float(tracks[s0, i, 0]), float(tracks[s0, i, 1])
        colors[i] = color_from_xy(x, y, image_width, image_height)
    return colors


def visualize_tracks_on_images(
    images: np.ndarray,  # (S, 3, H, W) or (S, H, W, 3)
    tracks: np.ndarray,  # (S, N, 2) pixel xy
    track_vis_mask: Optional[np.ndarray] = None,
    out_dir: str = "track_visuals_concat_by_xy",
    image_format: str = "CHW",
    normalize_mode: Optional[str] = "[0,1]",
    frames_per_row: int = 4,
    save_grid: bool = True,
) -> str:
    """Save per-frame track overlays (and a grid montage); returns out_dir."""
    import cv2

    images = np.asarray(images)
    tracks = np.asarray(tracks)
    if tracks.ndim == 4:
        tracks = tracks[0]
        images = images[0] if images.ndim == 5 else images
        if track_vis_mask is not None and track_vis_mask.ndim == 3:
            track_vis_mask = track_vis_mask[0]
    if image_format == "CHW":
        images = images.transpose(0, 2, 3, 1)
    S, H, W, _ = images.shape

    if normalize_mode == "[0,1]":
        frames = np.clip(images * 255.0, 0, 255).astype(np.uint8)
    elif normalize_mode == "[-1,1]":
        frames = np.clip((images + 1) * 127.5, 0, 255).astype(np.uint8)
    else:
        frames = np.clip(images, 0, 255).astype(np.uint8)

    colors = get_track_colors_by_position(tracks, track_vis_mask, W, H)
    os.makedirs(out_dir, exist_ok=True)
    rendered = []
    for s in range(S):
        frame = np.ascontiguousarray(frames[s])
        for i in range(tracks.shape[1]):
            if track_vis_mask is not None and not track_vis_mask[s, i]:
                continue
            x, y = int(round(tracks[s, i, 0])), int(round(tracks[s, i, 1]))
            if 0 <= x < W and 0 <= y < H:
                cv2.circle(frame, (x, y), 3, tuple(int(c) for c in colors[i]), -1)
        cv2.imwrite(os.path.join(out_dir, f"frame_{s:04d}.png"),
                    cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
        rendered.append(frame)

    if save_grid:
        rows = []
        for r0 in range(0, S, frames_per_row):
            row = rendered[r0: r0 + frames_per_row]
            while len(row) < frames_per_row:
                row.append(np.zeros_like(rendered[0]))
            rows.append(np.concatenate(row, axis=1))
        grid = np.concatenate(rows, axis=0)
        cv2.imwrite(os.path.join(out_dir, "tracks_grid.png"),
                    cv2.cvtColor(grid, cv2.COLOR_RGB2BGR))
    return out_dir

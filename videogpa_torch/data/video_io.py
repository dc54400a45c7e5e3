"""Video decode, frame sampling, VGGT preprocessing and mp4 writing (host
side; ``videogpa_tpu/data/video_io.py``).

- uniform sampling + center-crop 518: OpenCV's FFMPEG backend, linspace
  index selection and an INTER_LINEAR resize of the centred square;
- VGGT preprocessing: resize to width 518 keeping the aspect (height snapped
  to a multiple of 14, PIL bicubic), centre crop or pad to 518 x 518,
  (1, T, 3, 518, 518) float32 in [0, 1];
- mp4 export for the generation CLI: an ffmpeg x264 pipe with the
  reference's codec settings, else OpenCV's VideoWriter.

Numpy plus ``cv2`` and PIL, each imported inside the function that needs it
(the machine with the card has neither).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def read_video_frames(path: str, indices: Optional[np.ndarray] = None) -> np.ndarray:
    """Decode frames (all, or the given indices) -> (T, H, W, 3) RGB uint8."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise RuntimeError(f"cannot open video {path}")
    try:
        total = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        if indices is None:
            indices = np.arange(max(total, 0))
        wanted = set(int(i) for i in indices)
        frames = {}
        idx = 0
        max_wanted = max(wanted) if wanted else -1
        while idx <= max_wanted:
            ok, frame = cap.read()
            if not ok:
                break
            if idx in wanted:
                frames[idx] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
            idx += 1
        if not frames:
            raise RuntimeError(f"video has 0 decodable frames: {path}")
        # fill any missing wanted indices with the last decoded frame
        last = frames[max(frames)]
        return np.stack([frames.get(int(i), last) for i in indices], axis=0)
    finally:
        cap.release()


def video_frame_count(path: str) -> int:
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        return int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    finally:
        cap.release()


def center_crop_and_resize(frame: np.ndarray, size: int = 518) -> np.ndarray:
    """Center square crop then cv2 INTER_LINEAR resize to size x size."""
    import cv2

    h, w = frame.shape[:2]
    side = min(h, w)
    top = (h - side) // 2
    left = (w - side) // 2
    cropped = frame[top : top + side, left : left + side]
    return cv2.resize(cropped, (size, size), interpolation=cv2.INTER_LINEAR)


def sample_uniform_frames(path: str, n_frames: int = 48, size: int = 518) -> np.ndarray:
    """Uniformly sample n frames -> (T, size, size, 3) uint8 RGB."""
    total = video_frame_count(path)
    if total <= 0:
        # some containers don't report frame count; decode everything
        frames = read_video_frames(path)
        total = len(frames)
        n_eff = min(n_frames, total)
        idx = np.linspace(0, total - 1, n_eff).astype(int)
        frames = frames[idx]
    else:
        n_eff = min(n_frames, total)
        idx = np.linspace(0, total - 1, n_eff).astype(int)
        frames = read_video_frames(path, idx)
    return np.stack([center_crop_and_resize(f, size) for f in frames], axis=0)


def preprocess_images_vggt(
    frames: np.ndarray, mode: str = "crop", target_size: int = 518
) -> np.ndarray:
    """(T, H, W, 3) uint8 -> (1, T, 3, 518, 518) float32 in [0, 1]."""
    from PIL import Image

    if mode not in ("crop", "pad"):
        raise ValueError("mode must be 'crop' or 'pad'")
    T, H, W = frames.shape[:3]
    # fast path: already square at the target size -> one vectorised normalise
    if H == target_size and W == target_size:
        return frames.astype(np.float32).transpose(0, 3, 1, 2)[None] / 255.0
    out: List[np.ndarray] = []
    for frame in frames:
        img = Image.fromarray(frame, "RGB")
        w, h = img.size
        if mode == "pad" and h > w:
            new_h = target_size
            new_w = round(w * (new_h / h) / 14) * 14
        else:
            new_w = target_size
            new_h = round(h * (new_w / w) / 14) * 14
        if (new_w, new_h) != (w, h):
            img = img.resize((new_w, new_h), Image.Resampling.BICUBIC)
        t = np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0  # (3, H, W)
        if mode == "crop" and new_h > target_size:
            start = (new_h - target_size) // 2
            t = t[:, start : start + target_size]
        if mode == "pad":
            ph, pw = target_size - t.shape[1], target_size - t.shape[2]
            t = np.pad(
                t,
                ((0, 0), (ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)),
                constant_values=1.0,
            )
        out.append(t)
    return np.stack(out, axis=0)[None]


def _write_video_ffmpeg(path: str, frames: np.ndarray, fps: int) -> bool:
    """Encode via an ffmpeg subprocess (libx264 yuv420p, crf 23, preset fast
    — the reference's codec settings, ``generate/Wan2.2-TI2V-5B.py:24-38``).
    Returns False when ffmpeg is absent or fails, so callers can fall back.
    """
    import shutil
    import subprocess

    if shutil.which("ffmpeg") is None:
        return False
    t, h, w = frames.shape[:3]
    proc = subprocess.Popen(
        ["ffmpeg", "-y", "-f", "rawvideo", "-vcodec", "rawvideo",
         "-s", f"{w}x{h}", "-pix_fmt", "rgb24", "-r", str(fps), "-i", "-",
         "-c:v", "libx264", "-pix_fmt", "yuv420p", "-preset", "fast",
         "-crf", "23", str(path)],
        stdin=subprocess.PIPE,
        stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL,
    )
    try:
        proc.stdin.write(np.ascontiguousarray(frames, np.uint8).tobytes())
        proc.stdin.close()
    except BrokenPipeError:
        pass
    return proc.wait() == 0


def write_video(path: str, frames: np.ndarray, fps: int = 8) -> None:
    """(T, H, W, 3) uint8 RGB -> mp4.

    Prefers an ffmpeg x264 encode (reference parity); falls back to
    OpenCV's VideoWriter (avc1, then mp4v) when ffmpeg is unavailable.
    """
    frames = np.asarray(frames)
    if _write_video_ffmpeg(path, frames, fps):
        return
    import cv2

    h, w = frames[0].shape[:2]
    writer = None
    for fourcc in ("avc1", "mp4v"):
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*fourcc), fps, (w, h))
        if writer.isOpened():
            break
        writer.release()
        writer = None
    if writer is None:
        raise RuntimeError(f"no available mp4 encoder for {path}")
    try:
        for f in frames:
            writer.write(cv2.cvtColor(np.asarray(f), cv2.COLOR_RGB2BGR))
    finally:
        writer.release()

"""Writing generated videos (``videogpa_tpu/data/video_io.py::write_video``).

mp4 export for the generation CLI: an ffmpeg x264 pipe with the reference's
codec settings, else OpenCV's VideoWriter. Host code; ``cv2`` is imported
inside the function that needs it. Decoding and the scorer's preprocessing
are not ported yet.
"""

from __future__ import annotations

import numpy as np


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

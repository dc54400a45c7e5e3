"""COLMAP sparse-model reader (text and binary formats), a copy of
``videogpa_tpu/models/da3/colmap_io.py``.

Read-side counterpart of the colmap exporter in ``export.py`` — functional
equivalent of the reference's ``depth_anything_3/utils/read_write_model.py``
(the standard COLMAP model format; the reference's ``colmap`` CLI command
loads a model via ``read_model`` and runs pose-conditioned inference,
``depth_anything_3/cli.py:471``, ``services/input_handlers.py:108-160``).

Implemented on numpy + struct only. Supported camera models cover what DA3
emits/consumes: SIMPLE_PINHOLE, PINHOLE, SIMPLE_RADIAL, RADIAL, OPENCV
(distortion parameters are carried through but ignored when building K).
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Dict, List, Tuple

import numpy as np

# model_id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
MODEL_NAME_TO_ID = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclasses.dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray

    @property
    def K(self) -> np.ndarray:
        """3x3 intrinsics (distortion ignored)."""
        p = self.params
        if self.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL", "RADIAL",
                          "SIMPLE_RADIAL_FISHEYE", "RADIAL_FISHEYE", "FOV"):
            f, cx, cy = p[0], p[1], p[2]
            fx = fy = f
        else:
            fx, fy, cx, cy = p[0], p[1], p[2], p[3]
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)


@dataclasses.dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray  # (4,) w, x, y, z
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str
    xys: np.ndarray  # (P, 2)
    point3D_ids: np.ndarray  # (P,)

    @property
    def R(self) -> np.ndarray:
        """World-to-camera rotation from the quaternion."""
        w, x, y, z = self.qvec / np.linalg.norm(self.qvec)
        return np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ],
            np.float64,
        )

    @property
    def extrinsic(self) -> np.ndarray:
        """4x4 world-to-camera transform."""
        E = np.eye(4)
        E[:3, :3] = self.R
        E[:3, 3] = self.tvec
        return E


@dataclasses.dataclass
class ColmapPoint3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


# ---------------------------------------------------------------------------
# Text format
# ---------------------------------------------------------------------------

def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cams[int(parts[0])] = ColmapCamera(
                id=int(parts[0]),
                model=parts[1],
                width=int(parts[2]),
                height=int(parts[3]),
                params=np.array([float(x) for x in parts[4:]]),
            )
    return cams


def read_images_text(path: str) -> Dict[int, ColmapImage]:
    images = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f if not ln.startswith("#")]
    # each image is a (pose line, points2D line) pair; the points line is
    # legitimately EMPTY for pose-only models, so scan statefully: the first
    # non-blank line opens a pair and the immediately following line (blank
    # or not) is its points2D record
    i = 0
    pairs = []
    while i < len(lines):
        if not lines[i]:
            i += 1
            continue
        pts = lines[i + 1] if i + 1 < len(lines) else ""
        pairs.append((lines[i], pts))
        i += 2
    for pose_line, pts_raw in pairs:
        parts = pose_line.split()
        img_id = int(parts[0])
        pts_line = pts_raw.split()
        xys = np.array(
            [[float(pts_line[j]), float(pts_line[j + 1])]
             for j in range(0, len(pts_line), 3)]
        ).reshape(-1, 2)
        p3d = np.array(
            [int(pts_line[j + 2]) for j in range(0, len(pts_line), 3)], np.int64
        )
        images[img_id] = ColmapImage(
            id=img_id,
            qvec=np.array([float(x) for x in parts[1:5]]),
            tvec=np.array([float(x) for x in parts[5:8]]),
            camera_id=int(parts[8]),
            name=" ".join(parts[9:]),
            xys=xys,
            point3D_ids=p3d,
        )
    return images


def read_points3D_text(path: str) -> Dict[int, ColmapPoint3D]:
    pts = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            track = parts[8:]
            pts[int(parts[0])] = ColmapPoint3D(
                id=int(parts[0]),
                xyz=np.array([float(x) for x in parts[1:4]]),
                rgb=np.array([int(x) for x in parts[4:7]], np.uint8),
                error=float(parts[7]),
                image_ids=np.array(track[0::2], np.int64)
                if track else np.zeros((0,), np.int64),
                point2D_idxs=np.array(track[1::2], np.int64)
                if track else np.zeros((0,), np.int64),
            )
    return pts


# ---------------------------------------------------------------------------
# Binary format
# ---------------------------------------------------------------------------

def _read(f, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, width, height = _read(f, "<iiQQ")
            name, num_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{num_params}d"))
            cams[cam_id] = ColmapCamera(cam_id, name, width, height, params)
    return cams


def read_images_binary(path: str) -> Dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            img_id = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            cam_id = _read(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (num_pts,) = _read(f, "<Q")
            data = np.array(_read(f, f"<{3 * num_pts}d")).reshape(-1, 3)
            images[img_id] = ColmapImage(
                id=img_id, qvec=qvec, tvec=tvec, camera_id=cam_id,
                name=name.decode("utf-8"),
                xys=data[:, :2].copy(),
                point3D_ids=data[:, 2].astype(np.int64),
            )
    return images


def read_points3D_binary(path: str) -> Dict[int, ColmapPoint3D]:
    pts = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            pid = _read(f, "<Q")[0]
            xyz = np.array(_read(f, "<3d"))
            rgb = np.array(_read(f, "<3B"), np.uint8)
            (error,) = _read(f, "<d")
            (track_len,) = _read(f, "<Q")
            track = np.array(_read(f, f"<{2 * track_len}i")).reshape(-1, 2)
            pts[pid] = ColmapPoint3D(
                id=pid, xyz=xyz, rgb=rgb, error=error,
                image_ids=track[:, 0].astype(np.int64),
                point2D_idxs=track[:, 1].astype(np.int64),
            )
    return pts


# ---------------------------------------------------------------------------
# Top-level
# ---------------------------------------------------------------------------

def read_model(path: str):
    """Read a COLMAP sparse model directory (auto-detects .bin vs .txt).

    Returns (cameras, images, points3D) dicts keyed by id; points3D may be
    empty ({}), matching COLMAP models exported without a point cloud.
    """
    if os.path.isfile(os.path.join(path, "cameras.bin")):
        cameras = read_cameras_binary(os.path.join(path, "cameras.bin"))
        images = read_images_binary(os.path.join(path, "images.bin"))
        p3d_path = os.path.join(path, "points3D.bin")
        points3D = read_points3D_binary(p3d_path) if os.path.isfile(p3d_path) else {}
    elif os.path.isfile(os.path.join(path, "cameras.txt")):
        cameras = read_cameras_text(os.path.join(path, "cameras.txt"))
        images = read_images_text(os.path.join(path, "images.txt"))
        p3d_path = os.path.join(path, "points3D.txt")
        points3D = read_points3D_text(p3d_path) if os.path.isfile(p3d_path) else {}
    else:
        raise FileNotFoundError(f"no COLMAP model (cameras.bin/.txt) in {path}")
    return cameras, images, points3D


def load_colmap_scene(
    colmap_dir: str, sparse_subdir: str = ""
) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """ColmapHandler.process equivalent: a COLMAP project directory with
    ``images/`` and ``sparse/[subdir]`` -> (image_files, extrinsics [N,4,4],
    intrinsics [N,3,3]) sorted by image name."""
    images_dir = os.path.join(colmap_dir, "images")
    sparse_dir = os.path.join(colmap_dir, "sparse", sparse_subdir) if sparse_subdir \
        else os.path.join(colmap_dir, "sparse")
    if not os.path.isdir(sparse_dir):
        raise FileNotFoundError(f"sparse dir not found: {sparse_dir}")
    cameras, images, _ = read_model(sparse_dir)

    rows = []
    for img in images.values():
        path = os.path.join(images_dir, img.name)
        if not os.path.exists(path):
            continue
        cam = cameras.get(img.camera_id)
        if cam is None:
            continue
        rows.append((img.name, path, img.extrinsic, cam.K))
    rows.sort(key=lambda r: r[0])
    if not rows:
        raise ValueError(f"no usable (image, pose) pairs under {colmap_dir}")
    files = [r[1] for r in rows]
    extr = np.stack([r[2] for r in rows]).astype(np.float32)
    intr = np.stack([r[3] for r in rows]).astype(np.float32)
    return files, extr, intr

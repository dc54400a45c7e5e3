"""DA3 benchmark dataset loaders (``videogpa_tpu/models/da3/bench_datasets.py``):
the DTU, ETH3D, DTU-64, HiRoom, ScanNet++ and 7-Scenes on-disk formats.

Mirrors the reference loaders' file layouts and conventions
(``depth_anything_3/bench/datasets/{dtu,eth3d,sevenscenes}.py``):

- **DTU** (MVSNet eval layout): ``Rectified/<scene>/*.png`` images with view
  33 reordered first (the reference-view convention, ``dtu.py:109-110``),
  ``Cameras/{idx:08d}_cam.txt`` (``extrinsic`` on lines 2-5, ``intrinsic``
  on lines 8-10), GT point clouds ``Points/stl/stl{id:03d}_total.ply``.
- **ETH3D**: ``<scene>/dslr_calibration_jpg/{cameras.txt,images.txt}``
  (COLMAP text model, read with ``colmap_io``) + ``<scene>/images``
  and GT mesh ``<scene>/combined_mesh.ply``.
- **7-Scenes**: ``7Scenes/<scene>/seq-01/frame-{i:06d}.{color.png,pose.txt}``
  with the fixed Kinect intrinsics (fx=fy=585, cx=320, cy=240,
  ``utils/constants.py:182-185``); pose.txt is camera-to-world, inverted to
  the w2c convention. GT meshes ``7Scenes/meshes/<scene>.ply``.

Each loader registers into the same DATASET_REGISTRY the Evaluator consumes
and optionally subsamples frames (``max_views``) so full scenes fit scoring.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional

import numpy as np

from videogpa_torch.models.da3.bench import BenchDataset, Scene, register_dataset


def _load_image(path: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def read_ply_xyz(path: str) -> np.ndarray:
    """Minimal PLY vertex reader (ascii / binary_little_endian, float32 or
    float64 x,y,z leading properties)."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        n_vertex = int(
            next(l.split()[2] for l in header if l.startswith("element vertex"))
        )
        props = []
        in_vertex = False
        for line in header:
            if line.startswith("element"):
                in_vertex = line.startswith("element vertex")
            elif line.startswith("property") and in_vertex:
                _, typ, name = line.split()[:3]
                props.append((typ, name))

        np_types = {"float": "<f4", "float32": "<f4", "double": "<f8",
                    "float64": "<f8", "uchar": "u1", "uint8": "u1",
                    "char": "i1", "int8": "i1", "short": "<i2",
                    "ushort": "<u2", "int": "<i4", "uint": "<u4",
                    "int32": "<i4", "uint32": "<u4"}
        if fmt == "ascii":
            rows = []
            for _ in range(n_vertex):
                vals = f.readline().split()
                rows.append([float(vals[i]) for i in range(3)])
            return np.asarray(rows, np.float32)
        dtype = np.dtype([(name, np_types[typ]) for typ, name in props])
        raw = np.frombuffer(f.read(dtype.itemsize * n_vertex), dtype=dtype)
        return np.stack(
            [raw["x"], raw["y"], raw["z"]], axis=1
        ).astype(np.float32)


def _subsample(items: list, max_views: Optional[int]):
    if max_views is None or len(items) <= max_views:
        return items
    idx = np.linspace(0, len(items) - 1, max_views).astype(int)
    return [items[i] for i in idx]


@register_dataset("dtu")
def _dtu_factory():
    class DTUDataset(BenchDataset):
        name = "dtu"

        def __init__(self, root: Optional[str] = None, max_views: int = 10):
            self.root = root or os.environ.get("DTU_EVAL_DATA_ROOT", "dtu_eval")
            self.max_views = max_views

        def scenes(self) -> List[str]:
            d = os.path.join(self.root, "Rectified")
            if not os.path.isdir(d):
                return []
            return sorted(os.listdir(d))

        @staticmethod
        def read_cam_file(path: str):
            """DTU camera file: 'extrinsic' lines 2-5, 'intrinsic' lines 8-10
            (reference dtu.py:76-91)."""
            with open(path) as f:
                lines = [ln.rstrip() for ln in f.readlines()]
            extr = np.fromstring(
                " ".join(lines[1:5]), dtype=np.float32, sep=" "
            ).reshape(4, 4)
            intr = np.fromstring(
                " ".join(lines[7:10]), dtype=np.float32, sep=" "
            ).reshape(3, 3)
            return intr, extr

        def get_data(self, scene: str) -> Scene:
            rgb_dir = os.path.join(self.root, "Rectified", scene)
            cam_dir = os.path.join(self.root, "Cameras")
            files = sorted(glob.glob(os.path.join(rgb_dir, "*.png")))
            if len(files) > 33:  # reference-view reorder (dtu.py:109-110)
                files = [files[33]] + files[:33] + files[34:]
            files = _subsample(files, self.max_views)
            frames, extr, intr = [], [], []
            for fpath in files:
                idx = int(os.path.basename(fpath).split("_")[1]) - 1
                K, E = self.read_cam_file(
                    os.path.join(cam_dir, f"{idx:0>8}_cam.txt")
                )
                frames.append(_load_image(fpath))
                extr.append(E[:3])
                intr.append(K)
            gt_points = None
            scan_id = int(scene.replace("scan", "").split("_")[0])
            ply = os.path.join(self.root, "Points", "stl", f"stl{scan_id:03d}_total.ply")
            if os.path.isfile(ply):
                gt_points = read_ply_xyz(ply)
            return Scene(
                name=scene,
                frames=np.stack(frames),
                gt_extrinsics=np.stack(extr).astype(np.float32),
                gt_intrinsics=np.stack(intr).astype(np.float32),
                gt_points=gt_points,
            )

    return DTUDataset()


@register_dataset("eth3d")
def _eth3d_factory():
    class ETH3DDataset(BenchDataset):
        name = "eth3d"

        def __init__(self, root: Optional[str] = None, max_views: int = 10):
            self.root = root or os.environ.get("ETH3D_EVAL_DATA_ROOT", "eth3d_eval")
            self.max_views = max_views

        def scenes(self) -> List[str]:
            if not os.path.isdir(self.root):
                return []
            return sorted(
                d for d in os.listdir(self.root)
                if os.path.isdir(
                    os.path.join(self.root, d, "dslr_calibration_jpg")
                )
            )

        def get_data(self, scene: str) -> Scene:
            from videogpa_torch.models.da3.colmap_io import (
                read_cameras_text,
                read_images_text,
            )

            sdir = os.path.join(self.root, scene)
            calib = os.path.join(sdir, "dslr_calibration_jpg")
            cams = read_cameras_text(os.path.join(calib, "cameras.txt"))
            images = read_images_text(os.path.join(calib, "images.txt"))
            rows = []
            for img in images.values():
                path = os.path.join(sdir, "images", img.name)
                if not os.path.exists(path) or img.camera_id not in cams:
                    continue
                rows.append((img.name, path, img.extrinsic[:3], cams[img.camera_id].K))
            rows.sort(key=lambda r: r[0])
            rows = _subsample(rows, self.max_views)
            gt_points = None
            mesh = os.path.join(sdir, "combined_mesh.ply")
            if os.path.isfile(mesh):
                gt_points = read_ply_xyz(mesh)
            return Scene(
                name=scene,
                frames=np.stack([_load_image(r[1]) for r in rows]),
                gt_extrinsics=np.stack([r[2] for r in rows]).astype(np.float32),
                gt_intrinsics=np.stack([r[3] for r in rows]).astype(np.float32),
                gt_points=gt_points,
            )

    return ETH3DDataset()


@register_dataset("dtu64")
def _dtu64_factory():
    class DTU64Dataset(BenchDataset):
        """DTU-64 pose-eval variant (``bench/datasets/dtu64.py``):
        ``<scene>/image/{idx:08d}.png`` with a shared camera directory of
        DTU-format cam.txt files and the view-33 reference reorder."""

        name = "dtu64"

        def __init__(self, root: Optional[str] = None,
                     camera_root: Optional[str] = None, max_views: int = 10):
            self.root = root or os.environ.get("DTU64_EVAL_DATA_ROOT", "dtu64_eval")
            self.camera_root = camera_root or os.environ.get(
                "DTU64_CAMERA_ROOT", os.path.join(self.root, "Cameras")
            )
            self.max_views = max_views

        def scenes(self) -> List[str]:
            if not os.path.isdir(self.root):
                return []
            return sorted(
                d for d in os.listdir(self.root)
                if os.path.isdir(os.path.join(self.root, d, "image"))
            )

        def get_data(self, scene: str) -> Scene:
            read_cam = _dtu_factory().read_cam_file
            files = sorted(
                glob.glob(os.path.join(self.root, scene, "image", "*.png"))
            )
            if len(files) > 33:
                files = [files[33]] + files[:33] + files[34:]
            files = _subsample(files, self.max_views)
            frames, extr, intr = [], [], []
            for fpath in files:
                cam_idx = int(os.path.basename(fpath).split(".")[0])
                cam_file = os.path.join(self.camera_root, f"{cam_idx:0>8}_cam.txt")
                if not os.path.exists(cam_file):
                    continue
                K, E = read_cam(cam_file)
                frames.append(_load_image(fpath))
                extr.append(E[:3])
                intr.append(K)
            return Scene(
                name=scene,
                frames=np.stack(frames),
                gt_extrinsics=np.stack(extr).astype(np.float32),
                gt_intrinsics=np.stack(intr).astype(np.float32),
            )

    return DTU64Dataset()


@register_dataset("hiroom")
def _hiroom_factory():
    class HiRoomDataset(BenchDataset):
        """HiRoom (``bench/datasets/hiroom.py``): ``<scene>/image/*`` with
        per-frame w2c poses ``<scene>/pose/<frame>.npy`` and a shared
        ``cam_K.npy``; GT clouds under ``gt_root``."""

        name = "hiroom"

        def __init__(self, root: Optional[str] = None,
                     gt_root: Optional[str] = None, max_views: int = 10):
            self.root = root or os.environ.get("HIROOM_EVAL_DATA_ROOT", "hiroom_eval")
            self.gt_root = gt_root or os.environ.get(
                "HIROOM_GT_ROOT", os.path.join(self.root, "gt_pcd")
            )
            self.max_views = max_views

        def scenes(self) -> List[str]:
            if not os.path.isdir(self.root):
                return []
            return sorted(
                d for d in os.listdir(self.root)
                if os.path.isfile(os.path.join(self.root, d, "cam_K.npy"))
            )

        def get_data(self, scene: str) -> Scene:
            sdir = os.path.join(self.root, scene)
            K = np.load(os.path.join(sdir, "cam_K.npy")).astype(np.float32)
            items = []
            for img_name in sorted(os.listdir(os.path.join(sdir, "image"))):
                frame = img_name.split(".")[0]
                pose = os.path.join(sdir, "pose", f"{frame}.npy")
                if os.path.exists(pose):
                    items.append((os.path.join(sdir, "image", img_name), pose))
            items = _subsample(items, self.max_views)
            frames = [_load_image(i) for i, _ in items]
            extr = [np.load(p).astype(np.float32)[:3] for _, p in items]
            gt_points = None
            gt_name = "-".join(scene.split("/")[-3:]) + ".ply"
            gt_path = os.path.join(self.gt_root, gt_name)
            if os.path.isfile(gt_path):
                gt_points = read_ply_xyz(gt_path)
            return Scene(
                name=scene,
                frames=np.stack(frames),
                gt_extrinsics=np.stack(extr),
                gt_intrinsics=np.stack([K] * len(frames)),
                gt_points=gt_points,
            )

    return HiRoomDataset()


@register_dataset("scannetpp")
def _scannetpp_factory():
    class ScanNetPPDataset(BenchDataset):
        """ScanNet++ (``bench/datasets/scannetpp.py``): a COLMAP model under
        ``<scene>/merge_dslr_iphone/colmap/sparse_render_rgb`` with images in
        ``merge_dslr_iphone/images`` (iPhone frames only) and the GT mesh at
        ``scans/mesh_aligned_0.05.ply``."""

        name = "scannetpp"

        def __init__(self, root: Optional[str] = None, max_views: int = 10):
            self.root = root or os.environ.get(
                "SCANNETPP_EVAL_DATA_ROOT", "scannetpp_eval"
            )
            self.max_views = max_views

        def scenes(self) -> List[str]:
            if not os.path.isdir(self.root):
                return []
            return sorted(
                d for d in os.listdir(self.root)
                if os.path.isdir(
                    os.path.join(self.root, d, "merge_dslr_iphone")
                )
            )

        def get_data(self, scene: str) -> Scene:
            from videogpa_torch.models.da3.colmap_io import read_model

            base = os.path.join(self.root, scene, "merge_dslr_iphone")
            cams, images, _ = read_model(
                os.path.join(base, "colmap", "sparse_render_rgb")
            )
            rows = []
            for img in images.values():
                if "iphone" not in img.name:
                    continue
                path = os.path.join(base, "images", img.name)
                if not os.path.exists(path) or img.camera_id not in cams:
                    continue
                rows.append(
                    (img.name, path, img.extrinsic[:3], cams[img.camera_id].K)
                )
            rows.sort(key=lambda r: r[0])
            rows = _subsample(rows, self.max_views)
            gt_points = None
            mesh = os.path.join(self.root, scene, "scans", "mesh_aligned_0.05.ply")
            if os.path.isfile(mesh):
                gt_points = read_ply_xyz(mesh)
            return Scene(
                name=scene,
                frames=np.stack([_load_image(r[1]) for r in rows]),
                gt_extrinsics=np.stack([r[2] for r in rows]).astype(np.float32),
                gt_intrinsics=np.stack([r[3] for r in rows]).astype(np.float32),
                gt_points=gt_points,
            )

    return ScanNetPPDataset()


@register_dataset("7scenes")
def _sevenscenes_factory():
    class SevenScenesDataset(BenchDataset):
        name = "7scenes"
        FX = FY = 585.0
        CX, CY = 320.0, 240.0

        def __init__(self, root: Optional[str] = None, max_views: int = 10):
            self.root = root or os.environ.get(
                "SEVENSCENES_EVAL_DATA_ROOT", "sevenscenes_eval"
            )
            self.max_views = max_views

        def scenes(self) -> List[str]:
            d = os.path.join(self.root, "7Scenes")
            if not os.path.isdir(d):
                return []
            return sorted(
                s for s in os.listdir(d)
                if os.path.isdir(os.path.join(d, s)) and s != "meshes"
            )

        def get_data(self, scene: str) -> Scene:
            seq = "seq-02" if scene == "stairs" else "seq-01"
            folder = os.path.join(self.root, "7Scenes", scene, seq)
            K = np.array(
                [[self.FX, 0, self.CX], [0, self.FY, self.CY], [0, 0, 1]],
                np.float32,
            )
            items = []
            for pose_path in sorted(glob.glob(os.path.join(folder, "frame-*.pose.txt"))):
                img_path = pose_path.replace(".pose.txt", ".color.png")
                if os.path.exists(img_path):
                    items.append((img_path, pose_path))
            items = _subsample(items, self.max_views)
            frames, extr = [], []
            for img_path, pose_path in items:
                frames.append(_load_image(img_path))
                c2w = np.loadtxt(pose_path).reshape(4, 4)
                extr.append(np.linalg.inv(c2w)[:3])  # c2w -> w2c
            gt_points = None
            mesh = os.path.join(self.root, "7Scenes", "meshes", f"{scene}.ply")
            if os.path.isfile(mesh):
                gt_points = read_ply_xyz(mesh)
            return Scene(
                name=scene,
                frames=np.stack(frames),
                gt_extrinsics=np.stack(extr).astype(np.float32),
                gt_intrinsics=np.stack([K] * len(frames)),
                gt_points=gt_points,
            )

    return SevenScenesDataset()

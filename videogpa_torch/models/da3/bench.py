"""DA3 benchmark evaluator (``videogpa_tpu/models/da3/bench.py``): pose and
reconstruction evaluation over pluggable datasets.

The reference's bench subsystem (``depth_anything_3/bench/evaluator.py:41-100``,
``bench/registries.py``): an ``Evaluator`` over a lazy dataset registry,
scene sharding (``shard_id`` / ``total_shards``, the reference's gpu_id /
total_gpus) and the standard pose metrics (relative rotation and translation
accuracy, AUC@30). The model runs on its device; the TSDF fusion of the
recon modes on the same device; the metrics on the host.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from typing import Callable, Dict, List, Optional

import numpy as np

from videogpa_torch.models.da3.model import DA3, da3_inference
from videogpa_torch.models.da3.recon import evaluate_3d_reconstruction, fuse_depths_tsdf

DATASET_REGISTRY: Dict[str, Callable[[], "BenchDataset"]] = {}
_registry_lock = threading.Lock()


def register_dataset(name: str):
    def deco(factory):
        with _registry_lock:
            DATASET_REGISTRY[name] = factory
        return factory

    return deco


@dataclasses.dataclass
class Scene:
    name: str
    frames: np.ndarray  # (S, H, W, 3) uint8
    gt_extrinsics: Optional[np.ndarray] = None  # (S, 3, 4) w2c
    gt_intrinsics: Optional[np.ndarray] = None
    gt_points: Optional[np.ndarray] = None  # (N, 3) GT surface point cloud


class BenchDataset:
    """Contract mirror of reference ``bench/dataset.py:52-125``."""

    name = "base"

    def scenes(self) -> List[str]:
        raise NotImplementedError

    def get_data(self, scene: str) -> Scene:
        raise NotImplementedError


@register_dataset("npz_dir")
def _npz_dir_factory():
    """Scenes from a directory of .npz fixtures (frames + gt poses)."""

    class NpzDirDataset(BenchDataset):
        name = "npz_dir"

        def __init__(self, root: Optional[str] = None):
            self.root = root or os.environ.get("DA3_BENCH_DIR", "bench_scenes")

        def scenes(self):
            if not os.path.isdir(self.root):
                return []
            return sorted(
                os.path.splitext(f)[0]
                for f in os.listdir(self.root)
                if f.endswith(".npz")
            )

        def get_data(self, scene):
            d = np.load(os.path.join(self.root, scene + ".npz"))
            return Scene(
                name=scene,
                frames=d["frames"],
                gt_extrinsics=d.get("extrinsics"),
                gt_intrinsics=d.get("intrinsics"),
                gt_points=d.get("points"),
            )

    return NpzDirDataset()


# ---------------------------------------------------------------------------
# Pose metrics
# ---------------------------------------------------------------------------

def _rotation_angle_deg(R1: np.ndarray, R2: np.ndarray) -> np.ndarray:
    dR = np.einsum("sij,skj->sik", R1, R2)
    tr = np.clip((np.trace(dR, axis1=-2, axis2=-1) - 1) / 2, -1, 1)
    return np.degrees(np.arccos(tr))


def relative_pose_errors(pred: np.ndarray, gt: np.ndarray):
    """Pairwise relative rotation (deg) and translation-direction (deg) errors."""
    S = pred.shape[0]
    rot_errs, trans_errs = [], []
    for i in range(S):
        for j in range(i + 1, S):
            def rel(E):
                Ri, ti = E[i, :3, :3], E[i, :3, 3]
                Rj, tj = E[j, :3, :3], E[j, :3, 3]
                R = Rj @ Ri.T
                t = tj - R @ ti
                return R, t

            Rp, tp = rel(pred)
            Rg, tg = rel(gt)
            rot_errs.append(_rotation_angle_deg(Rp[None], Rg[None])[0])
            denom = np.linalg.norm(tp) * np.linalg.norm(tg)
            if denom < 1e-8:
                trans_errs.append(0.0)
            else:
                cos = np.clip(np.dot(tp, tg) / denom, -1, 1)
                trans_errs.append(float(np.degrees(np.arccos(cos))))
    return np.asarray(rot_errs), np.asarray(trans_errs)


def auc_at(errors: np.ndarray, max_deg: float = 30.0) -> float:
    """AUC of the recall curve up to max_deg (standard pose metric)."""
    if len(errors) == 0:
        return 0.0
    taus = np.linspace(1, max_deg, int(max_deg))
    recalls = [(errors <= t).mean() for t in taus]
    return float(np.mean(recalls))


# ---------------------------------------------------------------------------
# Evaluator
# ---------------------------------------------------------------------------

class Evaluator:
    """Modes: 'pose', 'recon_unposed', 'recon_posed'. Scene-sharded.

    The recon modes follow the reference's ``bench/evaluator.py:306-368``:
    fuse the depth maps into a TSDF on the model's device (with the predicted
    poses for recon_unposed, aligned to the GT trajectory first as the
    reference's unposed exports are, or the GT poses for recon_posed), then
    chamfer / F-score against the GT point cloud on the host.
    """

    VALID_MODES = ("pose", "recon_unposed", "recon_posed")

    def __init__(self, model: DA3, mode: str = "pose",
                 shard_id: int = 0, total_shards: int = 1,
                 voxel_size: float = 0.04, fscore_threshold: float = 0.05):
        if mode not in self.VALID_MODES:
            raise ValueError(f"mode {mode!r} not in {self.VALID_MODES}")
        self.model = model
        self.mode = mode
        self.shard_id = shard_id
        self.total_shards = total_shards
        self.voxel_size = voxel_size
        self.fscore_threshold = fscore_threshold

    def _eval_recon(self, scene: Scene, pred) -> dict:
        if self.mode == "recon_posed" and scene.gt_extrinsics is not None:
            extr = scene.gt_extrinsics
            intr = (scene.gt_intrinsics if scene.gt_intrinsics is not None
                    else pred.intrinsics)
        else:
            extr, intr = pred.extrinsics, pred.intrinsics
        fused = fuse_depths_tsdf(
            pred.depth, intr, extr, voxel_size=self.voxel_size,
            device=next(self.model.parameters()).device,
        )
        return evaluate_3d_reconstruction(
            fused, scene.gt_points, threshold=self.fscore_threshold,
            down_sample=self.voxel_size,
        )

    def run(self, dataset: BenchDataset, out_json: Optional[str] = None) -> dict:
        scenes = dataset.scenes()[self.shard_id :: self.total_shards]
        rows = []
        for name in scenes:
            scene = dataset.get_data(name)
            # unposed recon still aligns the trajectory to GT (sim3) so the
            # fused cloud lives in the GT frame, like the reference's exports
            gt_for_align = (scene.gt_extrinsics
                            if self.mode == "recon_unposed" else None)
            pred = da3_inference(self.model, scene.frames, gt_extrinsics=gt_for_align)
            row = {"scene": name, "views": int(scene.frames.shape[0])}
            if self.mode == "pose" and scene.gt_extrinsics is not None:
                rot, trans = relative_pose_errors(
                    pred.extrinsics, scene.gt_extrinsics
                )
                row.update(
                    rra5=float((rot <= 5).mean()),
                    rta5=float((trans <= 5).mean()),
                    auc30=auc_at(np.maximum(rot, trans), 30.0),
                )
            elif self.mode.startswith("recon") and scene.gt_points is not None:
                row.update(self._eval_recon(scene, pred))
            rows.append(row)
        summary = {"mode": self.mode, "scenes": len(rows), "rows": rows}
        for key in ("rra5", "rta5", "auc30", "acc", "comp", "overall",
                    "precision", "recall", "fscore"):
            vals = [r[key] for r in rows if key in r]
            if vals:
                summary[f"mean_{key}"] = float(np.mean(vals))
        if out_json:
            os.makedirs(os.path.dirname(os.path.abspath(out_json)), exist_ok=True)
            with open(out_json, "w") as f:
                json.dump(summary, f, indent=2)
        return summary


def print_metrics(summary: dict) -> None:
    print(f"[{summary['mode']}] scenes={summary['scenes']}")
    for k, v in summary.items():
        if k.startswith("mean_"):
            print(f"  {k}: {v:.4f}")

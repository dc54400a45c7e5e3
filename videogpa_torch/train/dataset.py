"""DPO preference-pair dataset (``videogpa_tpu/train/dataset.py``, copied).

Parity target: reference ``train/dataset.py:51-283`` — identical metadata
schema (documented there at :1-31) and pair-construction filters:

1. drop videos missing the metric / motion_norm / latent or condition paths
2. drop videos with motion_norm < motion_threshold (static scenes)
3. sort by metric (min = lower-better); winner = best, loser = worst
4. winner must beat metric_threshold; |winner - loser| >= min_gap

Artifacts: latents/conditions load from .npz (this framework's encoder
output) or torch .pt (reference-produced artifacts — interop), detected by
extension.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch


def _load_tensor_file(path: Path):
    """Load a latent/condition artifact: .npz (ours) or torch .pt (reference)."""
    p = str(path)
    if p.endswith(".npz") or p.endswith(".npy"):
        data = np.load(p, allow_pickle=False)
        if isinstance(data, np.lib.npyio.NpzFile):
            if set(data.files) == {"data"}:
                return data["data"]
            return {k: data[k] for k in data.files}
        return data
    obj = torch.load(p, map_location="cpu", weights_only=True)
    if isinstance(obj, dict):
        return {
            k: (v.float().numpy() if hasattr(v, "numpy") else v)
            for k, v in obj.items()
        }
    return obj.float().numpy()


class DPODataset:
    """Win/lose latent pairs built from scored metadata JSON."""

    def __init__(
        self,
        base_path: str,
        metadata_path: str,
        metric_name: str = "consistency_score",
        metric_mode: str = "min",
        min_gap: float = 0.1,
        metric_threshold: Optional[float] = None,
        motion_threshold: float = 0.001,
        max_samples: Optional[int] = None,
    ):
        self.base_path = Path(base_path)
        self.metric_name = metric_name
        self.metric_mode = metric_mode
        self.min_gap = min_gap
        self.metric_threshold = metric_threshold
        self.motion_threshold = motion_threshold

        with open(metadata_path) as f:
            data = json.load(f)
        if "groups" not in data:
            raise ValueError("Invalid metadata format: missing 'groups' key")
        self.raw_groups = data["groups"]
        self.preference_pairs = self._create_preference_pairs()
        if max_samples is not None:
            self.preference_pairs = self.preference_pairs[:max_samples]

    def _create_preference_pairs(self) -> List[Dict[str, Any]]:
        pairs = []
        for group in self.raw_groups:
            videos = group.get("videos", [])
            if len(videos) < 2:
                continue

            valid = []
            for v in videos:
                if self.metric_name not in v or "motion_norm" not in v:
                    continue
                if "latent_path" not in v or "condition_path" not in v:
                    continue
                if not (self.base_path / v["latent_path"]).exists():
                    continue
                if not (self.base_path / v["condition_path"]).exists():
                    continue
                if v["motion_norm"] < self.motion_threshold:
                    continue
                valid.append(v)
            if len(valid) < 2:
                continue

            reverse = self.metric_mode == "max"
            ordered = sorted(valid, key=lambda x: x[self.metric_name], reverse=reverse)
            winner, loser = ordered[0], ordered[-1]
            w_m, l_m = winner[self.metric_name], loser[self.metric_name]

            if self.metric_threshold is not None:
                if self.metric_mode == "min" and w_m >= self.metric_threshold:
                    continue
                if self.metric_mode == "max" and w_m <= self.metric_threshold:
                    continue
            gap = abs(w_m - l_m)
            if gap < self.min_gap:
                continue

            pairs.append(
                {
                    "group_id": group.get("group_id", "unknown"),
                    "prompt": group.get("text_prompt", group.get("prompt", "")),
                    "input_image_path": group.get(
                        "image_path", group.get("input_image_path")
                    ),
                    "original_video_path": group.get("original_video_path"),
                    "winner": winner,
                    "loser": loser,
                    "metric_gap": gap,
                }
            )
        return pairs

    def __len__(self) -> int:
        return len(self.preference_pairs)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        pair = self.preference_pairs[idx]
        winner, loser = pair["winner"], pair["loser"]
        x_win = _load_tensor_file(self.base_path / winner["latent_path"])
        x_lose = _load_tensor_file(self.base_path / loser["latent_path"])
        cond = _load_tensor_file(self.base_path / winner["condition_path"])

        result = {
            "x_win": np.asarray(x_win, np.float32),
            "x_lose": np.asarray(x_lose, np.float32),
            "prompt_emb": np.asarray(cond.get("encoder_hidden_states"), np.float32),
            "prompt": pair["prompt"],
            "m_win": float(winner[self.metric_name]),
            "m_lose": float(loser[self.metric_name]),
        }
        for key in ("image_embeds", "image_latent"):
            if isinstance(cond, dict) and cond.get(key) is not None:
                out_key = {"image_embeds": "image_emb", "image_latent": "image_latent"}[key]
                result[out_key] = np.asarray(cond[key], np.float32)
        return result


def collate(batch: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack a list of samples (reference ``train/dataset.py:261-283``)."""
    result: Dict[str, Any] = {}
    for key in ("x_win", "x_lose", "prompt_emb"):
        if key in batch[0]:
            result[key] = np.stack([b[key] for b in batch])
    for key in ("image_emb", "image_latent"):
        if key in batch[0] and batch[0][key] is not None:
            result[key] = np.stack([b[key] for b in batch])
    if "prompt" in batch[0]:
        result["prompt"] = [b["prompt"] for b in batch]
    for key in ("m_win", "m_lose"):
        if key in batch[0]:
            result[key] = np.asarray([b[key] for b in batch], np.float32)
    return result


def train_val_split(n: int, val_frac: float = 0.02, seed: int = 42):
    """98/2 random split (reference ``train/CogVideoX-I2V-5B/03_train.py:236-241``)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_train = int((1 - val_frac) * n)
    return perm[:n_train], perm[n_train:]

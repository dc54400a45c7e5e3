"""Parameter-tree and training-state persistence (``videogpa_tpu/checkpoint.py``).

Two layers:
- ``save_pytree`` / ``load_pytree``: flat .npz files of nested dicts/lists of
  tensors or arrays; keys are '/'-joined paths, integer path segments
  rebuild lists. The files are those of the JAX package's functions.
- ``TrainCheckpointer``: one ``torch.save`` file per training state (dicts,
  lists, tensors and numbers, read back with ``weights_only=True``), with
  top-k retention by a monitored metric (the reference's Lightning
  ModelCheckpoint, ``train/CogVideoX-I2V-5B/03_train.py:260-267``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

_STATE_FILE = "state.pt"


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif isinstance(tree, torch.Tensor):
        out[prefix[:-1]] = tree.detach().cpu().numpy()
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def save_pytree(tree: Any, path: str) -> None:
    flat = _flatten(tree)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path if path.endswith(".npz") else path + ".npz", **flat)


def load_pytree(path: str, to_device: bool = True) -> Any:
    """Rebuild the tree (``videogpa_tpu/checkpoint.py:41``): torch tensors as
    leaves (on the CPU: callers move them where they run), or with
    ``to_device=False`` the numpy arrays as read."""
    if not path.endswith(".npz") and os.path.exists(path + ".npz"):
        path = path + ".npz"
    root: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")
            node = root
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = torch.from_numpy(data[key]) if to_device else data[key]

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


class TrainCheckpointer:
    """One directory per saved step, top-k retention by a monitored metric."""

    def __init__(self, directory: str, save_top_k: int = 10, mode: str = "min"):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.save_top_k = save_top_k
        self.mode = mode
        self._scores_path = os.path.join(self.directory, "scores.json")
        self._scores: Dict[str, float] = {}
        if os.path.exists(self._scores_path):
            with open(self._scores_path) as f:
                self._scores = json.load(f)

    def save(self, step: int, state: Any, metric: Optional[float] = None) -> None:
        """Save ``state``: a dataclass (such as ``TrainState``) or any tree
        of dicts, lists, tensors and numbers. Tensors are written from the
        CPU."""
        name = f"step_{step:08d}"
        path = os.path.join(self.directory, name)
        os.makedirs(path, exist_ok=True)
        if dataclasses.is_dataclass(state):  # shallow: asdict would deep-copy every tensor
            state = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
        tmp = os.path.join(path, _STATE_FILE + ".tmp")
        torch.save(_to_cpu(state), tmp)
        os.replace(tmp, os.path.join(path, _STATE_FILE))
        self._scores[name] = float(metric) if metric is not None else float("inf")
        self._prune()
        with open(self._scores_path, "w") as f:
            json.dump(self._scores, f, indent=2)

    def _prune(self) -> None:
        if self.save_top_k <= 0 or len(self._scores) <= self.save_top_k:
            return
        reverse = self.mode == "max"
        ranked = sorted(self._scores.items(), key=lambda kv: kv[1], reverse=reverse)
        for name, _ in ranked[self.save_top_k:]:
            p = os.path.join(self.directory, name)
            if os.path.exists(p):
                shutil.rmtree(p)
            self._scores.pop(name, None)

    def latest(self) -> Optional[str]:
        names = sorted(n for n in self._scores)
        return os.path.join(self.directory, names[-1]) if names else None

    def restore(self, path: str, target: Any = None, device=None) -> Any:
        """Load a saved state; tensors go to ``device`` (CPU by default).
        With a dataclass ``target``, returns an instance of its class."""
        tree = torch.load(os.path.join(path, _STATE_FILE), map_location=device,
                          weights_only=True)
        if target is not None and dataclasses.is_dataclass(target):
            return type(target)(**tree)
        return tree


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree

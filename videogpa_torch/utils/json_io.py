"""Atomic JSON IO and per-video score summaries
(``videogpa_tpu/utils/json_io.py``).

``safe_save_json`` writes through a temporary file and ``os.replace``, so an
interrupted or concurrent run never leaves a torn metadata file;
``save_score_json`` drops keys that start with "_".
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, Optional


def safe_load_json(path: str, default: Optional[Any] = None) -> Any:
    if not os.path.exists(path):
        if default is not None:
            return default
        raise FileNotFoundError(path)
    with open(path) as f:
        return json.load(f)


def safe_save_json(data: Any, path: str) -> None:
    """Write JSON atomically (temp file + os.replace)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(data, f, indent=2)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save_score_json(results: Dict[Any, Any], out_path: str) -> None:
    """Per-video score summary; drops keys starting with '_'."""
    serializable = {}
    for th, metrics in results.items():
        if isinstance(th, str) and th.startswith("_"):
            continue
        serializable[str(th)] = {
            k: float(v) for k, v in metrics.items() if not k.startswith("_")
        }
    safe_save_json(serializable, out_path)

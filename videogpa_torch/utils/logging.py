"""Training metric stream: JSONL on disk, W&B-compatible keys
(``videogpa_tpu/utils/logging.py``).

The same ``train/*``, ``val/*`` and ``stats/samples_per_sec`` series as the
reference's WandbLogger; if ``WANDB_API_KEY`` is set and ``wandb`` imports,
it is an additional sink, otherwise everything lands in ``metrics.jsonl``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricLogger:
    def __init__(self, out_dir: str, project: Optional[str] = None,
                 name: Optional[str] = None, config: Optional[dict] = None):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self.start_time = time.time()
        self._wandb = None
        if os.environ.get("WANDB_API_KEY"):
            try:
                import wandb
            except ImportError:
                wandb = None
            if wandb is not None:
                wandb.login(key=os.environ["WANDB_API_KEY"])
                self._wandb = wandb.init(project=project, name=name, config=config)
        if config is not None:
            self.log_raw({"_config": config})

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        rec = {"step": step, "time": round(time.time() - self.start_time, 2)}
        rec.update({k: float(v) for k, v in metrics.items()})
        self.log_raw(rec)
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def log_raw(self, rec: dict) -> None:
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def throughput(self, step: int, batch_size: int, n_devices: int = 1) -> float:
        elapsed = time.time() - self.start_time
        return step * n_devices * batch_size / elapsed if elapsed > 0 else 0.0

    def close(self) -> None:
        self._f.close()
        if self._wandb is not None:
            self._wandb.finish()

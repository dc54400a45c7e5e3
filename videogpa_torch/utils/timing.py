"""Per-stage wall-clock timing (``videogpa_tpu/utils/timing.py``).

One ``StageTimer`` covers the reference's per-stage timers of the DA3 api
(input processing / forward / output processing) and the scoring driver's
total hours. ``sync`` is called before and after each stage; pass
``torch.cuda.synchronize`` to time device work, since CUDA launches return
before the work ends.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Callable, Dict, Optional


class StageTimer:
    def __init__(self, sync: Optional[Callable[[], None]] = None, verbose: bool = False):
        self.sync = sync
        self.verbose = verbose
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextmanager
    def stage(self, name: str):
        if self.sync is not None:
            self.sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync is not None:
                self.sync()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            if self.verbose:
                print(f"[timer] {name}: {dt * 1000:.1f} ms")

    def mean(self, name: str) -> float:
        return self.totals.get(name, 0.0) / max(self.counts.get(name, 0), 1)

    def summary(self) -> Dict[str, dict]:
        return {k: {"total_s": round(self.totals[k], 4), "count": self.counts[k],
                    "mean_ms": round(1000 * self.mean(k), 2)}
                for k in self.totals}

    def report(self) -> str:
        return "\n".join(f"{k}: {v['total_s']:.2f}s total, {v['count']}x, "
                         f"{v['mean_ms']:.1f} ms/it" for k, v in self.summary().items())

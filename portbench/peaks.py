"""Published peaks of the cards the benchmark knows (NVIDIA's data sheet,
SXM part, dense rates without sparsity, at the full 700 W power limit)."""

from __future__ import annotations

from typing import Optional

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12},
}


def peak(device_name: str) -> Optional[dict]:
    return PEAKS.get(device_name)

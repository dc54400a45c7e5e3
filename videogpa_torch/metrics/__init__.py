"""Metric suite of the scorer: MSE/PSNR/SSIM/LPIPS/Consistency/MVCS/Epipolar.

- ``videogpa_torch.metrics.functional`` — tensor functions over whole clips.
- ``videogpa_torch.metrics.api`` — the reference-compatible classes and
  ``build_metrics``.
"""

from videogpa_torch.metrics.api import (
    ConsistencyScore,
    EpipolarMetric,
    LPIPSMetric,
    Metric,
    MSEMetric,
    MVCSMetric,
    PSNRMetric,
    SSIMMetric,
    build_metrics,
)

__all__ = [
    "ConsistencyScore",
    "EpipolarMetric",
    "LPIPSMetric",
    "Metric",
    "MSEMetric",
    "MVCSMetric",
    "PSNRMetric",
    "SSIMMetric",
    "build_metrics",
]

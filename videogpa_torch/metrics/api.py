"""Metric classes with the reference's call contract (``videogpa_tpu/metrics/api.py``):
``metric.compute(gt=..., rep=..., **kw) -> float`` over whole clips, with the
same input-range and layout coercions.

These are the metrics the scorer fuses on the device. Epipolar (host-side
OpenCV SIFT) comes with the decode slice: ``EpipolarMetric`` raises.
"""

from __future__ import annotations

import os
from abc import ABC, abstractmethod
from typing import Any, Dict, Optional

import numpy as np
import torch

from videogpa_torch.checkpoint import load_pytree
from videogpa_torch.convert import load_jax_params
from videogpa_torch.device import resolve_device
from videogpa_torch.metrics import functional as F
from videogpa_torch.models.lpips import LPIPS, lpips_distance


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


def _tchw(x) -> torch.Tensor:
    """Layout normalisation to (T, C, H, W) float32."""
    x = _tensor(x)
    if x.dim() == 3:
        x = x[None]
    if x.shape[-1] in (1, 3) and x.shape[1] not in (1, 3):
        x = x.permute(0, 3, 1, 2)
    return x.float()


def lpips_clip(model: LPIPS, gt: torch.Tensor, rep: torch.Tensor) -> torch.Tensor:
    """Mean LPIPS over a clip's frames, gt/rep (T, 3, H, W) in any range."""
    g = F.to_sym_range(gt)
    r = F._match_size(g, F.to_sym_range(rep))
    return lpips_distance(model, g, r).mean()


class Metric(ABC):
    def __init__(self, name: str):
        self.name = name

    @abstractmethod
    def compute(self, *, gt, rep, **kwargs) -> float:
        raise NotImplementedError

    def __call__(self, *args: Any, **kwargs: Any) -> float:
        return self.compute(*args, **kwargs)


class MSEMetric(Metric):
    def __init__(self):
        super().__init__("mse")

    def compute(self, *, gt, rep, **kwargs) -> float:
        return float(F.mse(_tchw(gt), _tchw(rep)))


class PSNRMetric(Metric):
    def __init__(self, **_):
        super().__init__("psnr")

    def compute(self, *, gt, rep, **kwargs) -> float:
        return float(F.psnr(_tchw(gt), _tchw(rep)))


class SSIMMetric(Metric):
    def __init__(self, **_):
        super().__init__("ssim")

    def compute(self, *, gt, rep, **kwargs) -> float:
        return float(F.ssim(_tchw(gt), _tchw(rep)))


class LPIPSMetric(Metric):
    """LPIPS with the given network, else ``_default_lpips(device)``; without
    either the distance is 0."""

    def __init__(self, lpips_params: Optional[LPIPS] = None, device=None, **_):
        super().__init__("lpips")
        self.params = lpips_params if lpips_params is not None else _default_lpips(device)

    def compute(self, *, gt, rep, **kwargs) -> float:
        if self.params is None:
            return 0.0
        dev = next(self.params.parameters()).device
        with torch.no_grad():
            return float(lpips_clip(self.params, _tchw(gt).to(dev), _tchw(rep).to(dev)))


class ConsistencyScore(Metric):
    """MSE + ratio x LPIPS, with the camera-motion score returned beside it.
    ratio defaults to 1, the reference signature's default that executes.
    Without a network (given, or ``_default_lpips(device)``) it is MSE only."""

    def __init__(self, lpips_params: Optional[LPIPS] = None, device=None, **_):
        super().__init__("Consistency_Score")
        self.params = lpips_params if lpips_params is not None else _default_lpips(device)

    def compute(self, *, gt, rep, extrinsics, ratio: float = 1, **kwargs):
        gt_t, rep_t = _tchw(gt), _tchw(rep)
        val = F.mse(gt_t, rep_t)
        if self.params is not None:
            dev = next(self.params.parameters()).device
            with torch.no_grad():
                val = val + ratio * lpips_clip(self.params, gt_t.to(dev), rep_t.to(dev)).cpu()
        return float(val), float(F.motion_score(_tensor(extrinsics)))


class MVCSMetric(Metric):
    def __init__(self, **_):
        super().__init__("MVCS")

    def compute(self, *, gt, rep, depths, intrinsics, extrinsics, **kwargs) -> float:
        d = _tensor(depths).float()
        if d.dim() == 4:
            d = d[:, 0] if d.shape[1] == 1 else d[..., 0]
        K = _tensor(intrinsics).float()
        if K.shape[-2:] == (4, 4):
            K = K[..., :3, :3]
        return float(F.mvcs(d, K, to_44(_tensor(extrinsics).float())))


class EpipolarMetric(Metric):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "the Epipolar metric (host-side OpenCV SIFT, find_fundamental, "
            "sampson_distance) is not ported yet: it comes with the decode slice")

    def compute(self, *, gt, rep, **kwargs) -> float:  # pragma: no cover
        raise NotImplementedError


def to_44(extr: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) world->camera -> (..., 4, 4) with the [0, 0, 0, 1] row."""
    if extr.shape[-2:] == (3, 4):
        bottom = torch.tensor([0.0, 0, 0, 1], dtype=extr.dtype, device=extr.device)
        extr = torch.cat([extr, bottom.expand(extr.shape[:-2] + (1, 4))], dim=-2)
    return extr


_LPIPS_CACHE: Dict[str, Any] = {}


def _default_lpips(device=None) -> Optional[LPIPS]:
    """The LPIPS network whose converted tree ``VIDEOGPA_LPIPS_PATH`` names
    (a ``save_pytree`` file of the JAX package's ``lpips_init`` tree), on
    ``resolve_device(device)``: the card unless the caller asks for the CPU.
    ``None`` when the variable is unset or names no file. The tree is read
    once, as the JAX package's ``_default_lpips`` reads it; the module is
    built once for each device."""
    if "tree" not in _LPIPS_CACHE:
        path = os.environ.get("VIDEOGPA_LPIPS_PATH")
        _LPIPS_CACHE["tree"] = load_pytree(path) if path and os.path.exists(path) else None
    if _LPIPS_CACHE["tree"] is None:
        return None
    dev = resolve_device(device)
    if str(dev) not in _LPIPS_CACHE:
        _LPIPS_CACHE[str(dev)] = load_jax_params(LPIPS(), _LPIPS_CACHE["tree"]).eval().to(dev)
    return _LPIPS_CACHE[str(dev)]


def build_metrics(lpips_params: Optional[LPIPS] = None, device=None) -> Dict[str, Metric]:
    """The scorer's metric set (reference ``replicate_scorer.py:63-74``)
    without Epipolar, which is not ported yet. Without ``lpips_params`` the
    network is ``_default_lpips(device)``, the converted weights that
    ``VIDEOGPA_LPIPS_PATH`` names; where there are none the LPIPS term is 0
    (MSE-only consistency score), as in the JAX package."""
    lp = lpips_params if lpips_params is not None else _default_lpips(device)
    return {
        "MSE": MSEMetric(),
        "Consistency_Score": ConsistencyScore(lp),
        "MVCS": MVCSMetric(),
        "PSNR": PSNRMetric(),
        "SSIM": SSIMMetric(),
        "LPIPS": LPIPSMetric(lp),
    }

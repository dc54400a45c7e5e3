"""VideoProcessor: the 3D-consistency reward scorer on the VGGT backbone
(``videogpa_tpu/reward/processor.py``).

For each clip: VGGT -> camera poses and depth -> world points -> confidence
filter -> z-buffer reprojection into every camera -> the metric suite on
(original, reprojected) frames. Everything from the upload of the raw uint8
frames to the metric scalars runs on the device; only (K,) scores and the
(K, S, 3, 4) extrinsics come back, as in the JAX package's fused scorer
(``_device_fn_scored``).

The entry point is ``process_frames_batch`` on decoded, square uint8 frames
of the model's size (518^2 for VGGT-1B): what ``cli/score.py`` hands over
after its decode thread. Epipolar, where the metric set holds it, is
computed on the host from those frames (SIFT matching). Decode, host
preprocessing of other frame sizes and the per-metric host path come with a
later slice and raise here.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from videogpa_torch.device import resolve_device
from videogpa_torch.geometry import batch_reproject, depth_to_world_points
from videogpa_torch.geometry.pose_enc import pose_encoding_to_extri_intri
from videogpa_torch.metrics import functional as F
from videogpa_torch.metrics.api import lpips_clip, to_44
from videogpa_torch.models.vggt import VGGT, VGGTConfig, vggt_forward
from videogpa_torch.reward.pointcloud import colored_pointcloud

DEFAULT_VGGT_MODEL = "facebook/VGGT-1B"


class VideoProcessor:
    """Compute 3D-consistency scores for generated clips.

    Args:
        metrics: name -> Metric (``videogpa_torch.metrics.build_metrics``).
        params: the VGGT module (``vggt_init`` or converted weights), on
            ``device``.
        config: VGGT config (default: the module's, else VGGT-1B).
        backbone: "vggt" (default; also the VIDEO_PROCESSOR_BACKBONE env
            var, or a "depth-anything" ``model_name``); "da3" raises.
        compute_dtype: trunk dtype (bf16 on the card).
        dpt_chunk: frames per DPT-head chunk.
        zbuffer_impl: "packed" (default, or VIDEOGPA_ZBUFFER), "scatter" or
            "sorted" (see ``geometry.projection``).
        dpt_dtype: DPT dtype; default VIDEOGPA_DPT_BF16 if set, else f32 for
            an f32 ``compute_dtype`` and bf16 otherwise.
        attn_impl: the backbone's attention impl; "flash_int8" with a model
            quantised by ``ops.quant.quantize_scorer_params`` is the int8 mode.
        device: where the scorer runs; ``None`` means ``cuda``.
    """

    FUSABLE_METRICS = ("MSE", "PSNR", "SSIM", "LPIPS", "Consistency_Score", "MVCS")

    def __init__(self, metrics: Dict[str, Any], params: Optional[VGGT] = None,
                 config: Optional[VGGTConfig] = None, model_name: Optional[str] = None,
                 backbone: Optional[str] = None, compute_dtype: torch.dtype = torch.bfloat16,
                 dpt_chunk: int = 8, zbuffer_impl: Optional[str] = None,
                 dpt_dtype: Optional[torch.dtype] = None, device=None,
                 attn_impl: str = "auto"):
        self.metrics = metrics
        self.backbone = self._resolve_backbone(backbone, model_name)
        if self.backbone == "da3":
            raise NotImplementedError("the DA3 backbone is not ported yet (a later slice)")
        self.device = resolve_device(device)
        self.params = params
        self.config = config or (params.cfg if params is not None else VGGTConfig())
        self.compute_dtype = compute_dtype
        self.attn_impl = attn_impl
        self.dpt_chunk = dpt_chunk
        self.zbuffer_impl = zbuffer_impl or os.environ.get("VIDEOGPA_ZBUFFER", "packed")
        if dpt_dtype is not None:
            self.dpt_dtype = dpt_dtype
        elif "VIDEOGPA_DPT_BF16" in os.environ:
            self.dpt_dtype = (torch.bfloat16 if os.environ["VIDEOGPA_DPT_BF16"] == "1"
                              else torch.float32)
        else:
            self.dpt_dtype = torch.float32 if compute_dtype == torch.float32 else torch.bfloat16

    @staticmethod
    def _resolve_backbone(backbone, model_name) -> str:
        if backbone:
            return backbone.lower()
        env_backbone = os.getenv("VIDEO_PROCESSOR_BACKBONE")
        if env_backbone:
            return env_backbone.lower()
        if model_name and "depth-anything" in model_name.lower():
            return "da3"
        return "vggt"

    # ------------------------------------------------------------------
    # Device program
    # ------------------------------------------------------------------

    def _fused_lpips_params(self):
        for name in ("Consistency_Score", "LPIPS"):
            m = self.metrics.get(name)
            if m is not None and getattr(m, "params", None) is not None:
                return m.params
        return None

    def _upload(self, all_frames: Sequence[np.ndarray]) -> torch.Tensor:
        """(K, S, H, W, 3) uint8 on the device; the normalisation runs there."""
        first = all_frames[0]
        size = first.shape[2] if first.ndim == 4 else None
        if not (first.dtype == np.uint8 and first.ndim == 4 and first.shape[1] == size
                and size in (518, self.config.img_size)):
            raise NotImplementedError(
                "the port scores square uint8 frames of the model's size "
                f"({self.config.img_size}); host preprocessing of other frames "
                "(preprocess_images_vggt) comes with the decode slice")
        # Epipolar needs only the host gt frames, so it rides the fused path
        allowed = set(self.FUSABLE_METRICS) | {"Epipolar"}
        if os.environ.get("VIDEOGPA_NO_FUSED_METRICS") == "1" or any(
                n not in allowed for n in self.metrics):
            raise NotImplementedError(
                "the port computes the fused on-device metrics "
                f"{self.FUSABLE_METRICS} and Epipolar; the per-metric host path "
                "comes with a later slice")
        if self.params is None:
            raise RuntimeError("VideoProcessor needs backbone params (videogpa_torch."
                               "models.vggt.vggt_init or converted weights)")
        return torch.from_numpy(np.stack(all_frames)).to(self.device)

    def _reproject_clip(self, extr, intr, depth, conf, colors, conf_thres: float):
        H, W = depth.shape[-2:]
        world = depth_to_world_points(depth, extr, intr)
        pts, cols, mask = colored_pointcloud(
            {"world_points_from_depth": world, "depth_conf": conf, "images": colors},
            "depth", conf_thres)
        return batch_reproject(pts, cols, intr, extr, H, W, valid=mask,
                               zbuffer_impl=self.zbuffer_impl, unit_colors=False)

    @torch.no_grad()
    def _scored(self, images_u8: torch.Tensor, conf_thres: float):
        """Backbone -> geometry -> reprojection -> metric scalars for K clips
        of raw uint8 frames (K, S, H, W, 3). Returns ((K,) score tensors by
        name, (K, S, 3, 4) extrinsics), all on the device, nothing synced."""
        names = [n for n in self.metrics if n in self.FUSABLE_METRICS]
        lpips = self._fused_lpips_params()
        images = images_u8.float().permute(0, 1, 4, 2, 3) / 255.0  # gt, (K, S, 3, H, W)
        H, W = images.shape[-2:]
        preds = vggt_forward(self.params, images, compute_dtype=self.compute_dtype,
                             dpt_chunk=self.dpt_chunk, dpt_dtype=self.dpt_dtype,
                             attn_impl=self.attn_impl)
        extr, intr = pose_encoding_to_extri_intri(preds["pose_enc"], (H, W))
        depth = preds["depth"][..., 0]
        conf = preds["depth_conf"]
        # one clip at a time, as the JAX package's lax.map: the per-clip
        # projection intermediates are O(S * H * W) points x S views
        reproj = [self._reproject_clip(extr[i], intr[i], depth[i], conf[i], images[i],
                                       conf_thres) for i in range(images.shape[0])]
        K = len(reproj)

        def per_clip(fn):
            return torch.stack([fn(i) for i in range(K)])

        scores: Dict[str, torch.Tensor] = {}
        mse_vals = (per_clip(lambda i: F.mse(images[i], reproj[i]))
                    if "MSE" in names or "Consistency_Score" in names else None)
        if "MSE" in names:
            scores["MSE"] = mse_vals
        if "PSNR" in names:
            scores["PSNR"] = per_clip(lambda i: F.psnr(images[i], reproj[i]))
        if "SSIM" in names:
            scores["SSIM"] = per_clip(lambda i: F.ssim(images[i], reproj[i]))
        lpips_vals = None
        if lpips is not None and ("LPIPS" in names or "Consistency_Score" in names):
            lpips_vals = per_clip(lambda i: lpips_clip(lpips, images[i], reproj[i]))
        if "LPIPS" in names:
            scores["LPIPS"] = (lpips_vals if lpips_vals is not None
                               else torch.zeros((K,), device=images.device))
        if "Consistency_Score" in names:
            # ratio 1.0: the reference signature's default, which executes
            scores["Consistency_Score"] = (mse_vals if lpips_vals is None
                                           else mse_vals + 1.0 * lpips_vals)
            scores["motion_norm"] = per_clip(lambda i: F.motion_score(extr[i]))
        if "MVCS" in names:
            scores["MVCS"] = per_clip(lambda i: F.mvcs(depth[i], intr[i], to_44(extr[i])))
        return scores, extr

    def _assemble_fused(self, host: Dict[str, np.ndarray], i: int,
                        gt_frames: np.ndarray) -> Dict[str, float]:
        r: Dict[str, float] = {}
        for name, metric in self.metrics.items():
            if name == "Epipolar":
                r[name] = metric.compute(gt=gt_frames, rep=None)
                continue
            r[name] = float(host[name][i])
            if name == "Consistency_Score":
                r["motion_norm"] = float(host["motion_norm"][i])
        return r

    # ------------------------------------------------------------------
    # Public API (reference-compatible)
    # ------------------------------------------------------------------

    def process_frames_batch(self, all_frames: Sequence[np.ndarray],
                             thresholds) -> List[Dict[Any, Any]]:
        """Score K decoded clips (a list of (S, H, W, 3) uint8 arrays) in one
        device program per threshold. Returns one result dict per clip:
        {threshold: {metric: float, ..., "motion_norm": float},
        "_extrinsic": (S, 3, 4) list}."""
        images = self._upload(all_frames)
        results: List[Dict[Any, Any]] = [dict() for _ in all_frames]
        for th in thresholds:
            scores, extr = self._scored(images, float(th))
            host = {k: v.cpu().numpy() for k, v in scores.items()}
            extr_np = extr.cpu().numpy()
            for i, r in enumerate(results):
                r[th] = self._assemble_fused(host, i, all_frames[i])
                r["_extrinsic"] = extr_np[i].tolist()
        return results

    def process_frames(self, frames_np: np.ndarray, thresholds, save_visuals: bool = False,
                       out_dir: Optional[str] = None) -> Dict[Any, Any]:
        """One clip, frames_np (T, H, W, 3) uint8 RGB (pre-cropped)."""
        if save_visuals:
            raise NotImplementedError("save_visuals writes PNGs with OpenCV: "
                                      "it comes with the decode slice")
        return self.process_frames_batch([frames_np], thresholds)[0]

    def process_frames_async(self, frames_np: np.ndarray,
                             thresholds) -> Callable[[], Dict[Any, Any]]:
        """Enqueue one clip's scoring on the current CUDA stream without
        waiting for it; returns a zero-argument callable that pulls the
        scalars (the first sync) and assembles the ``process_frames`` schema.
        Enqueueing clip i+1 before pulling clip i hides the host's work
        behind the device's."""
        images = self._upload([frames_np])
        pending = [(th, *self._scored(images, float(th))) for th in thresholds]

        def result() -> Dict[Any, Any]:
            results: Dict[Any, Any] = {}
            extr_np = None
            for th, scores, extr in pending:
                host = {k: v.cpu().numpy() for k, v in scores.items()}
                extr_np = extr.cpu().numpy()[0]
                results[th] = self._assemble_fused(host, 0, frames_np)
            results["_extrinsic"] = extr_np.tolist() if extr_np is not None else None
            return results

        return result

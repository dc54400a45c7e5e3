"""VideoProcessor: the 3D-consistency reward scorer on the VGGT or DA3
backbone (``videogpa_tpu/reward/processor.py``).

For each clip: sample frames uniformly -> VGGT or DA3 -> camera poses and
depth -> world points -> confidence filter -> z-buffer reprojection into
every camera -> the metric suite on (original, reprojected) frames. DA3
takes ImageNet-normalised frames of any size (sides divisible by 14) and
unprojects its depth in its own convention (``unproject_depth`` with the
camera->world inverse of its extrinsics); the colours of its point cloud are
the normalised frames mapped back to [0, 1].

Two paths, as in the JAX package:

- fused (``_scored``, the JAX ``_device_fn_scored``): uint8 frames (for VGGT
  square ones of the model's size, 518^2 for VGGT-1B; for DA3 any size) go
  up raw and everything from their normalisation to the metric scalars runs
  on the device; only (K,) scores and the (K, S, 3, 4) extrinsics come back.
  DA3 scores fused from float frames too, uploaded in [0, 1] and normalised
  on the device. Epipolar, where the metric set
  holds it, is computed on the host from the frames (SIFT matching).
- per-metric (``_reprojected``, the JAX ``_device_fn_batched``, then
  ``compute_metrics``): VGGT frames of another size go through the host's VGGT
  preprocessing (``data.video_io.preprocess_images_vggt``), and the metrics
  run one by one against the original frames; also for a metric set with a
  metric the device path does not fuse, under ``VIDEOGPA_NO_FUSED_METRICS=1``
  and for ``save_visuals``.

``process`` / ``process_paths`` decode clips from files (OpenCV, imported at
first use).
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from videogpa_torch.data import video_io
from videogpa_torch.device import resolve_device
from videogpa_torch.geometry import (
    batch_reproject, closed_form_inverse_se3, depth_to_world_points, unproject_depth)
from videogpa_torch.geometry.pose_enc import pose_encoding_to_extri_intri
from videogpa_torch.metrics import functional as F
from videogpa_torch.metrics.api import lpips_clip, to_44
from videogpa_torch.models.da3 import DA3Config, da3_forward
from videogpa_torch.models.da3.model import IMAGENET_MEAN, IMAGENET_STD
from videogpa_torch.models.vggt import VGGTConfig, vggt_forward
from videogpa_torch.reward.pointcloud import colored_pointcloud

DEFAULT_VGGT_MODEL = "facebook/VGGT-1B"
DEFAULT_DA3_MODEL = "depth-anything/DA3-Large"


class VideoProcessor:
    """Compute 3D-consistency scores for generated clips.

    Args:
        metrics: name -> Metric (``videogpa_torch.metrics.build_metrics``).
        params: the backbone module (``vggt_init`` / ``da3_init``, ``load_vggt``
            / ``load_da3`` or converted weights), on ``device``.
        config: backbone config (default: the module's, else VGGT-1B or
            DA3-Large).
        backbone: "vggt" (default) or "da3"; also the VIDEO_PROCESSOR_BACKBONE
            env var, or a "depth-anything" ``model_name``.
        compute_dtype: trunk dtype (bf16 on the card); DA3's heads run f32.
        dpt_chunk: frames per DPT-head chunk (VGGT; DA3's DualDPT takes all).
        zbuffer_impl: "packed" (default, or VIDEOGPA_ZBUFFER), "scatter" or
            "sorted" (see ``geometry.projection``).
        dpt_dtype: DPT dtype; default VIDEOGPA_DPT_BF16 if set, else f32 for
            an f32 ``compute_dtype`` and bf16 otherwise (VGGT).
        attn_impl: the backbone's attention impl; "flash_int8" with a model
            quantised by ``ops.quant.quantize_scorer_params`` is the int8 mode.
        device: where the scorer runs; ``None`` means ``cuda``.
    """

    FUSABLE_METRICS = ("MSE", "PSNR", "SSIM", "LPIPS", "Consistency_Score", "MVCS")

    def __init__(self, metrics: Dict[str, Any], params: Optional[torch.nn.Module] = None,
                 config=None, model_name: Optional[str] = None,
                 backbone: Optional[str] = None, compute_dtype: torch.dtype = torch.bfloat16,
                 dpt_chunk: int = 8, zbuffer_impl: Optional[str] = None,
                 dpt_dtype: Optional[torch.dtype] = None, device=None,
                 attn_impl: str = "auto"):
        self.metrics = metrics
        self.backbone = self._resolve_backbone(backbone, model_name)
        self.device = resolve_device(device)
        self.params = params
        default_cfg = DA3Config if self.backbone == "da3" else VGGTConfig
        self.config = config or (params.cfg if params is not None else default_cfg())
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
    # Device programs
    # ------------------------------------------------------------------

    def _fused_lpips_params(self):
        for name in ("Consistency_Score", "LPIPS"):
            m = self.metrics.get(name)
            if m is not None and getattr(m, "params", None) is not None:
                return m.params
        return None

    def _raw_ok(self, frames: np.ndarray) -> bool:
        """Whether a clip goes up raw: uint8 frames, for VGGT square ones of
        the model's size."""
        if frames.dtype != np.uint8 or frames.ndim != 4:
            return False
        return self.backbone == "da3" or (frames.shape[1] == frames.shape[2]
                                          and frames.shape[2] in (518, self.config.img_size))

    def _upload(self, all_frames: Sequence[np.ndarray]):
        """(images on the device, whether they are the metrics' ground truth):
        (K, S, H, W, 3) uint8; else for DA3 the frames as (K, S, 3, H, W) f32
        in [0, 1] (both normalised on the device); else the host's VGGT
        preprocessing, (K, S, 3, H', 518) f32 in [0, 1] (H' <= 518), which
        is not the ground truth."""
        if self.params is None:
            raise RuntimeError("VideoProcessor needs backbone params (videogpa_torch."
                               "models.vggt.vggt_init / models.da3.da3_init, load_vggt / "
                               "load_da3 or converted weights)")
        if self._raw_ok(all_frames[0]):
            return torch.from_numpy(np.stack(all_frames)).to(self.device), True
        if self.backbone == "da3":
            imgs = np.stack([f.astype(np.float32).transpose(0, 3, 1, 2) / 255.0
                             for f in all_frames])
            return torch.from_numpy(imgs).to(self.device), True
        imgs = np.stack([video_io.preprocess_images_vggt(f)[0] for f in all_frames])
        return torch.from_numpy(imgs).to(self.device), False

    def _fused_ok(self, gt_is_upload: bool) -> bool:
        """Fused on-device scoring applies when every requested metric is
        device-computable (Epipolar allowed: it only needs the host's frames)
        and the uploaded images ARE the metrics' ground truth (``_upload``)."""
        if os.environ.get("VIDEOGPA_NO_FUSED_METRICS") == "1":
            return False
        allowed = set(self.FUSABLE_METRICS) | {"Epipolar"}
        return gt_is_upload and all(n in allowed for n in self.metrics)

    def _warn_unfused(self) -> None:
        """Say once that the per-metric path runs and why."""
        if getattr(self, "_warned_unfused", False):
            return
        self._warned_unfused = True
        unfusable = [n for n in self.metrics
                     if n not in set(self.FUSABLE_METRICS) | {"Epipolar"}]
        why = (f"non-fusable metric(s): {', '.join(unfusable)}" if unfusable
               else "inputs are not the raw-upload gt (non-518/non-uint8), or "
                    "VIDEOGPA_NO_FUSED_METRICS=1")
        warnings.warn(f"fused on-device scoring disabled ({why}); falling back to the "
                      "per-metric path, which computes each metric on its own", stacklevel=3)

    def _reproject_clip(self, extr, intr, depth, conf, colors, conf_thres: float):
        H, W = depth.shape[-2:]
        if self.backbone == "da3":
            world = unproject_depth(depth[None, ..., None], intr[None],
                                    closed_form_inverse_se3(extr)[None])[0]
        else:
            world = depth_to_world_points(depth, extr, intr)
        pts, cols, mask = colored_pointcloud(
            {"world_points_from_depth": world, "depth_conf": conf, "images": colors},
            "depth", conf_thres)
        return batch_reproject(pts, cols, intr, extr, H, W, valid=mask,
                               zbuffer_impl=self.zbuffer_impl, unit_colors=False)

    @torch.no_grad()
    def _reprojected(self, images: torch.Tensor, conf_thres: float) -> Dict[str, Any]:
        """Backbone -> geometry -> reprojection for K clips: raw uint8 (K, S,
        H, W, 3) or f32 (K, S, 3, H, W) in [0, 1] (``_upload``). Returns the
        gt images in [0, 1] (K, S, 3, H, W), the reprojections (K clips of
        (S, 3, H, W) in [-1, 1]), extrinsic (K, S, 3, 4), intrinsic and depth,
        all on the device (the JAX package's ``_device_fn_batched``)."""
        if images.dtype == torch.uint8:
            images = images.float().permute(0, 1, 4, 2, 3) / 255.0
        H, W = images.shape[-2:]
        if self.backbone == "da3":
            mean = torch.tensor(IMAGENET_MEAN, device=images.device).reshape(1, 1, 3, 1, 1)
            std = torch.tensor(IMAGENET_STD, device=images.device).reshape(1, 1, 3, 1, 1)
            x = (images - mean) / std
            out = da3_forward(self.params, x, attn_impl=self.attn_impl,
                              compute_dtype=self.compute_dtype)
            extr, intr = out["extrinsics"], out["intrinsics"]
            depth, conf = out["depth"], out["depth_conf"]
            # the point cloud's colours are the normalised frames mapped back,
            # as in the JAX package: a colour an ulp off can round to another
            # 8-bit level in the reprojection
            colors = x * std + mean
        else:
            preds = vggt_forward(self.params, images, compute_dtype=self.compute_dtype,
                                 dpt_chunk=self.dpt_chunk, dpt_dtype=self.dpt_dtype,
                                 attn_impl=self.attn_impl)
            extr, intr = pose_encoding_to_extri_intri(preds["pose_enc"], (H, W))
            depth = preds["depth"][..., 0]
            conf = preds["depth_conf"]
            colors = images
        # one clip at a time, as the JAX package's lax.map: the per-clip
        # projection intermediates are O(S * H * W) points x S views
        reproj = [self._reproject_clip(extr[i], intr[i], depth[i], conf[i], colors[i],
                                       conf_thres) for i in range(len(images))]
        return {"images": images, "reprojected": reproj, "extrinsic": extr,
                "intrinsic": intr, "depth": depth}

    @torch.no_grad()
    def _scored(self, images: torch.Tensor, conf_thres: float):
        """Backbone -> geometry -> reprojection -> metric scalars for K clips
        whose upload is their ground truth (``_upload``). Returns ((K,)
        score tensors by name, (K, S, 3, 4) extrinsics), all on the device,
        nothing synced."""
        names = [n for n in self.metrics if n in self.FUSABLE_METRICS]
        lpips = self._fused_lpips_params()
        out = self._reprojected(images, conf_thres)
        images, reproj = out["images"], out["reprojected"]  # gt, (K, S, 3, H, W)
        extr, intr, depth = out["extrinsic"], out["intrinsic"], out["depth"]
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

    def _results_fused(self, images: torch.Tensor, all_frames: Sequence[np.ndarray],
                       thresholds) -> List[Dict[Any, Any]]:
        """The fused path's result dicts for K uploaded clips."""
        results: List[Dict[Any, Any]] = [dict() for _ in all_frames]
        for th in thresholds:
            scores, extr = self._scored(images, float(th))
            host = {k: v.cpu().numpy() for k, v in scores.items()}
            extr_np = extr.cpu().numpy()
            for i, r in enumerate(results):
                r[th] = self._assemble_fused(host, i, all_frames[i])
                r["_extrinsic"] = extr_np[i].tolist()
        return results

    # ------------------------------------------------------------------
    # Public API (reference-compatible)
    # ------------------------------------------------------------------

    def process(self, video_path: str, thresholds, num_frames: int, save_visuals: bool = False,
                out_dir: Optional[str] = None) -> Dict[Any, Any]:
        """Decode ``num_frames`` uniformly sampled, centre-cropped 518^2 frames
        of a video and score them (``process_frames``)."""
        frames_np = video_io.sample_uniform_frames(video_path, n_frames=num_frames)
        return self.process_frames(frames_np, thresholds, save_visuals, out_dir)

    def process_paths(self, video_paths, thresholds, num_frames: int,
                      decode_workers: int = 4) -> List[Dict[Any, Any]]:
        """Decode a batch of clips on a thread pool, then score them in one
        device program per threshold (``process_frames_batch``)."""
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=decode_workers) as pool:
            all_frames = list(pool.map(
                lambda p: video_io.sample_uniform_frames(p, n_frames=num_frames), video_paths))
        return self.process_frames_batch(all_frames, thresholds)

    def process_frames_batch(self, all_frames: Sequence[np.ndarray],
                             thresholds) -> List[Dict[Any, Any]]:
        """Score K decoded clips (a list of (S, H, W, 3) uint8 arrays) in one
        device program per threshold. Returns one result dict per clip:
        {threshold: {metric: float, ..., "motion_norm": float},
        "_extrinsic": (S, 3, 4) list}."""
        images, gt_is_upload = self._upload(all_frames)
        if self._fused_ok(gt_is_upload):
            return self._results_fused(images, all_frames, thresholds)
        self._warn_unfused()
        results: List[Dict[Any, Any]] = [dict() for _ in all_frames]
        for th in thresholds:
            out = self._reprojected(images, float(th))
            extr_np = out["extrinsic"].cpu().numpy()
            for i, r in enumerate(results):
                r[th] = self.compute_metrics(
                    all_frames[i], out["reprojected"][i], out["extrinsic"][i],
                    intrinsics=out["intrinsic"][i], depths=out["depth"][i])
                r["_extrinsic"] = extr_np[i].tolist()
        return results

    def process_frames(self, frames_np: np.ndarray, thresholds, save_visuals: bool = False,
                       out_dir: Optional[str] = None) -> Dict[Any, Any]:
        """One clip, frames_np (T, H, W, 3) uint8 RGB (pre-cropped). With
        ``save_visuals`` and ``out_dir`` each threshold's reprojections are
        written as PNGs under ``out_dir/th{th}/reprojections``."""
        images, gt_is_upload = self._upload([frames_np])
        if not save_visuals and self._fused_ok(gt_is_upload):
            return self._results_fused(images, [frames_np], thresholds)[0]
        results: Dict[Any, Any] = {}
        extr_np = None
        for th in thresholds:
            out = self._reprojected(images, float(th))
            extr_np = out["extrinsic"][0].cpu().numpy()
            if save_visuals and out_dir is not None:
                self._dump_reprojections(out["reprojected"][0], out_dir, th)
            results[th] = self.compute_metrics(
                frames_np, out["reprojected"][0], out["extrinsic"][0],
                intrinsics=out["intrinsic"][0], depths=out["depth"][0])
        results["_extrinsic"] = extr_np.tolist() if extr_np is not None else None
        return results

    def process_frames_async(self, frames_np: np.ndarray,
                             thresholds) -> Callable[[], Dict[Any, Any]]:
        """Enqueue one clip's scoring on the current CUDA stream without
        waiting for it; returns a zero-argument callable that pulls the
        scalars (the first sync) and assembles the ``process_frames`` schema.
        Enqueueing clip i+1 before pulling clip i hides the host's work
        behind the device's. Only the fused path does this: raises
        ``RuntimeError`` otherwise, so a caller can use ``process_frames``."""
        images, gt_is_upload = self._upload([frames_np])
        if not self._fused_ok(gt_is_upload):
            raise RuntimeError("process_frames_async needs the fused scoring path "
                               "(device-computable metrics + raw-upload gt)")
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

    def compute_metrics(self, gt_frames, rep_frames, extrinsics, intrinsics=None,
                        depths=None) -> Dict[str, float]:
        """Each metric on one clip: gt the host's frames, rep (S, 3, H, W) in
        [-1, 1] on the device."""
        results: Dict[str, float] = {}
        for name, metric_fn in self.metrics.items():
            if name == "Consistency_Score":
                score, motion = metric_fn.compute(gt=gt_frames, rep=rep_frames,
                                                  extrinsics=extrinsics)
                results[name] = score
                results["motion_norm"] = motion
            elif name == "MVCS":
                results[name] = metric_fn.compute(gt=gt_frames, rep=rep_frames, depths=depths,
                                                  intrinsics=intrinsics,
                                                  extrinsics=self._to_44(extrinsics))
            else:
                results[name] = metric_fn.compute(gt=gt_frames, rep=rep_frames)
        return results

    @staticmethod
    def _to_44(extr) -> torch.Tensor:
        extr = extr if isinstance(extr, torch.Tensor) else torch.from_numpy(np.asarray(extr))
        return to_44(extr)

    @staticmethod
    def _dump_reprojections(reproj: torch.Tensor, out_dir: str, th) -> None:
        """(S, 3, H, W) reprojections in [-1, 1] -> ``out_dir/th{th}/
        reprojections/{i:03d}.png``."""
        import cv2

        d = os.path.join(out_dir, f"th{th}", "reprojections")
        os.makedirs(d, exist_ok=True)
        imgs = ((reproj.float() + 1.0) * 127.5).cpu().numpy().clip(0, 255).astype(np.uint8)
        for i, img in enumerate(imgs.transpose(0, 2, 3, 1)):
            cv2.imwrite(os.path.join(d, f"{i:03d}.png"), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))

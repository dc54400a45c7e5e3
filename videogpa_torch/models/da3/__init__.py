"""Depth Anything 3 (DA3): the reference's default scoring backbone
(``videogpa_tpu/models/da3``), and DA3 served as a depth-and-pose model.

DINOv2 AA-ViT with alternating local/global attention from ``alt_start``,
reference-view selection, camera-token injection, the DualDPT depth + ray
head and the camera decoder (and encoder, for GT camera conditioning). The
replicate flow scores with it (``replicate.sh``'s ``SCORE_BACKBONE="da3"``).
Beside it: the mono / metric nets (``mono.py``), the nested
``da3nested-giant-large`` (``nested.py``), the Gaussian branch and its
splatting renderer (``gaussians.py``, ``gs_render.py``), the export pack
(``export.py``), the ``da3`` CLI (``cli.py``) and its HTTP backend
(``service.py``); and the evaluation half: TSDF fusion and chamfer / F-score
(``recon.py``), the ``Evaluator`` (``bench.py``) and its dataset loaders
(``bench_datasets.py``).
"""

from videogpa_torch.models.da3.config import DA3Config
from videogpa_torch.models.da3.gaussians import (
    GSDPT, Gaussians, gaussian_adapter, gsdpt_forward, gsdpt_init, save_gs_ply)
from videogpa_torch.models.da3.gs_render import render_3dgs, run_renderer_chunked
from videogpa_torch.models.da3.model import (
    DA3, DA3Prediction, da3_forward, da3_inference, da3_init)
from videogpa_torch.models.da3.mono import (
    DA3Mono, mono_config, mono_forward, mono_inference, mono_init)
from videogpa_torch.models.da3.nested import NestedPrediction, align_to_metric, nested_inference

__all__ = ["DA3", "DA3Config", "DA3Mono", "DA3Prediction", "GSDPT", "Gaussians",
           "NestedPrediction", "align_to_metric", "da3_forward", "da3_inference", "da3_init",
           "gaussian_adapter", "gsdpt_forward", "gsdpt_init", "mono_config", "mono_forward",
           "mono_inference", "mono_init", "nested_inference", "render_3dgs",
           "run_renderer_chunked", "save_gs_ply"]

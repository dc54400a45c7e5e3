"""Depth Anything 3 (DA3): the reference's default scoring backbone
(``videogpa_tpu/models/da3``).

DINOv2 AA-ViT with alternating local/global attention from ``alt_start``,
reference-view selection, camera-token injection, the DualDPT depth + ray
head and the camera decoder (and encoder, for GT camera conditioning). The
replicate flow scores with it (``replicate.sh``'s ``SCORE_BACKBONE="da3"``).
"""

from videogpa_torch.models.da3.config import DA3Config
from videogpa_torch.models.da3.model import (
    DA3, DA3Prediction, da3_forward, da3_inference, da3_init)

__all__ = ["DA3", "DA3Config", "DA3Prediction", "da3_forward", "da3_inference", "da3_init"]

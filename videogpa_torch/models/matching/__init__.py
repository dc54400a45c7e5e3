"""Learned keypoint matching: the SuperPoint detector and the LightGlue
matcher (``videogpa_tpu/models/matching``)."""

from videogpa_torch.models.matching.lightglue import (
    LightGlue,
    LightGlueConfig,
    convert_lightglue,
    lightglue_config_of,
    lightglue_init,
    lightglue_match,
    log_assignment,
)
from videogpa_torch.models.matching.superpoint import (
    SuperPoint,
    SuperPointConfig,
    convert_superpoint,
    extract_keypoints,
    superpoint_config_of,
    superpoint_forward,
    superpoint_init,
)

__all__ = [
    "SuperPointConfig",
    "superpoint_init",
    "superpoint_forward",
    "extract_keypoints",
    "convert_superpoint",
    "LightGlueConfig",
    "lightglue_init",
    "lightglue_match",
    "convert_lightglue",
    "SuperPoint",
    "LightGlue",
    "superpoint_config_of",
    "lightglue_config_of",
    "log_assignment",
]

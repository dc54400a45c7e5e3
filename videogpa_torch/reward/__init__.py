"""Geometry reward scorer: frames -> pose/depth -> reprojection -> scores."""

from videogpa_torch.reward.pointcloud import colored_pointcloud, confidence_mask
from videogpa_torch.reward.processor import VideoProcessor

__all__ = ["VideoProcessor", "colored_pointcloud", "confidence_mask"]

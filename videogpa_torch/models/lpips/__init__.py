"""LPIPS perceptual distance (VGG16 backbone)."""

from videogpa_torch.models.lpips.lpips import LPIPS, convert_lpips, lpips_distance, lpips_init

__all__ = ["LPIPS", "convert_lpips", "lpips_distance", "lpips_init"]

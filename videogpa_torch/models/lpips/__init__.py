"""LPIPS perceptual distance (VGG16 backbone)."""

from videogpa_torch.models.lpips.lpips import LPIPS, lpips_distance, lpips_init

__all__ = ["LPIPS", "lpips_distance", "lpips_init"]

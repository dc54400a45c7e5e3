"""VGGT-1B (DINOv2 patch embed, alternating-attention aggregator, camera and
DPT heads): the reward scorer's geometry backbone; with ``enable_track`` its
track head, and beside it the VGGSfM tracker and the SfM pack
(``track``, ``vggsfm_tracker``, ``sfm``, ``visual_track``)."""

from videogpa_torch.models.vggt.config import VGGTConfig
from videogpa_torch.models.vggt.model import VGGT, vggt_forward, vggt_init

__all__ = ["VGGT", "VGGTConfig", "vggt_forward", "vggt_init"]

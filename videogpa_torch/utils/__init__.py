"""Host-side utilities: atomic JSON IO, the metric logger, stage timing and
a numpy safetensors codec."""

from videogpa_torch.utils.json_io import safe_load_json, safe_save_json
from videogpa_torch.utils.logging import MetricLogger
from videogpa_torch.utils.timing import StageTimer

__all__ = ["MetricLogger", "StageTimer", "safe_load_json", "safe_save_json"]

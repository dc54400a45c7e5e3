"""Host-side utilities: the metric logger and a numpy safetensors codec."""
